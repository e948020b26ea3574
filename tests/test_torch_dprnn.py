"""DPRNN-TasNet (`models/dprnn.py`, `train/tasnet_trainer.py`) against the
benchmark's plain reference (`benchmark/reference/dprnn.py`) on seeded
random weights at a tiny size on the CPU: segmentation and overlap-add,
the separated waveforms, the loss and every gradient leaf, on the plain
route and on the kernel route (the kernels' plain versions here), one
clipped Adam step, the parameter count at the paper's widths, and
`run.train --mode tasnet`."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.reference import dprnn as ref  # noqa: E402
from benchmark.reference.train import Adam  # noqa: E402
from benchmark.traffic.mixing import Batch  # noqa: E402
from dl4ss_tpu_torch.config import preset  # noqa: E402
from dl4ss_tpu_torch.data.synth import MixtureBatch  # noqa: E402
from dl4ss_tpu_torch.models.dprnn import (DPRNN,  # noqa: E402
                                          DPRNNConfig, overlap_add,
                                          segment)
from dl4ss_tpu_torch.train.tasnet_trainer import (  # noqa: E402
    create_tasnet_state, make_tasnet_train_step, tasnet_loss)

TINY = DPRNNConfig(filters=8, kernel=2, bottleneck=8, hidden=8, blocks=2,
                   chunk=6, hop=3, speakers=2)
SAMPLES = 400      # 0.05 s at 8 kHz
CFG = preset("tdaa").replace(max_len_seconds=SAMPLES / 8000, batch_size=2,
                             learning_rate=1e-3, lr_schedule="constant",
                             grad_clip_norm=5.0, db_range=5.0,
                             augment_data=True)


@pytest.fixture(autouse=True, scope="module")
def _one_math_thread():
    """Tiny shapes: one host thread for the CPU's math, so that on a
    machine busy with other processes its threads do not wait on each
    other (tens of times slower there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _model(seed: int = 3):
    params = ref.make_params(dataclasses.asdict(TINY), seed, "cpu")
    model = DPRNN(TINY, device="cpu")
    model.load_state_dict(params, strict=True)
    return model, params


def _batch(seed: int = 4):
    g = torch.Generator().manual_seed(seed)
    sources = torch.randn((2, 2, SAMPLES), generator=g)
    sources[:, 1] *= 0.6
    return Batch(sources.sum(dim=1), sources, torch.zeros((2, 2)))


@pytest.mark.parametrize("frames", [17, 18, 19, 20, 399])
def test_segment_then_overlap_add_counts_each_frame(frames):
    """Every frame comes back times the chunks that hold it: twice at a
    hop of half a chunk, once in the first and the last half chunk of the
    padded signal; the reference's explicit slices agree."""
    y = torch.randn((2, frames, 5))
    chunks = segment(y, TINY)
    front, back = TINY.padding(frames)
    assert back >= TINY.hop and (frames + front + back - TINY.chunk) \
        % TINY.hop == 0
    assert chunks.shape == (2, TINY.num_chunks(frames), TINY.chunk, 5)
    m = dataclasses.asdict(TINY)
    assert torch.equal(chunks, ref.segment(y, m))
    back_ = overlap_add(chunks, frames, TINY)
    assert torch.allclose(back_, 2 * y)
    assert torch.allclose(ref.overlap_add(chunks, frames, m), 2 * y)


def test_published_widths_and_chunking():
    """A 4-s segment gives T' = 31,999 frames in S = 257 chunks; the
    parameter count in closed form (two LSTM biases a direction, as
    `nn.LSTM` has), the program's and the reference's leaves all read
    2,595,649."""
    m = DPRNNConfig()
    assert m.padding(31999) == (125, 126)
    assert m.num_chunks(31999) == 257
    n, d, h, c = m.filters, m.bottleneck, m.hidden, m.speakers
    lstm = 2 * (4 * h * (d + h) + 8 * h)
    block = 2 * (lstm + 2 * h * d + d + 2 * d)
    assert (n * m.kernel + 2 * n + n * d + d + m.blocks * block + 1
            + d * c * n + c * n + n * m.kernel) == 2_595_649
    model = DPRNN(m, device="cpu")
    w = F.conv1d(torch.zeros((1, 1, 32000)), model.encoder.w[:, None])
    assert w.shape[-1] == 31999
    assert sum(p.numel() for p in model.parameters()) == 2_595_649
    spec = ref.param_spec(dataclasses.asdict(m))
    assert sum(ref._numel(leaf.shape) for leaf in spec) == 2_595_649
    assert {leaf.name for leaf in spec} == set(model.state_dict())


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel_route"])
def test_forward_loss_and_gradients_match_the_reference(use_pallas):
    """The waveforms, the loss and the gradient of every leaf from the
    same weights and batch."""
    model, params = _model()
    batch = _batch()
    cfg = CFG.replace(use_pallas_rnn=use_pallas)
    est = model(batch.mix, use_pallas)
    m = dataclasses.asdict(TINY)
    want = ref.separate(params, batch.mix, m)
    assert est.shape == (2, 2, SAMPLES)
    assert _rel(est.detach(), want) < 1e-5
    mb = MixtureBatch(batch.mix, batch.sources, batch.spk_idx,
                      torch.ones((2, 2)))
    loss = tasnet_loss(model, mb, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    opt = Adam(dict(params), list(params), dict(
        learning_rate=1e-3, lr_schedule="constant", grad_clip_norm=5.0))
    ref_params = {k: v.clone() for k, v in params.items()}
    ref_loss, ref_grads = ref.tasnet_step(ref_params, opt, batch, m)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    for n, g in zip(names, grads):
        assert float(ref_grads[n].norm()) > 0.0, n
        assert _rel(g, ref_grads[n]) < 1e-4, n


def test_train_step_takes_the_references_adam_step():
    """Two steps of `make_tasnet_train_step` on batches drawn from the
    bank against the reference's clipped Adam on the same batches: the
    losses and the parameters after each step."""
    from benchmark.traffic.mixing import replay_batch
    bank = torch.randn((5, 3, SAMPLES), generator=torch.Generator()
                       .manual_seed(6))
    state = create_tasnet_state(CFG, TINY, 0, device="cpu")
    params = ref.make_params(dataclasses.asdict(TINY), 8, "cpu")
    state.model.load_state_dict(params, strict=True)
    state.generator.manual_seed(11)
    step = make_tasnet_train_step(CFG)
    c = dict(batch_size=2, max_mix=2, min_mix=2, augment_data=True,
             db_range=5.0, learning_rate=1e-3, lr_schedule="constant",
             grad_clip_norm=5.0)
    m = dataclasses.asdict(TINY)
    ref_params = {k: v.clone() for k, v in params.items()}
    opt = ref.optimizer(ref_params, c)
    gen = torch.Generator().manual_seed(11)
    for i in range(2):
        _, metrics = step(state, bank)
        loss, _ = ref.tasnet_step(ref_params, opt,
                                  replay_batch(gen, bank, c), m)
        assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5), i
        for n, p in state.model.named_parameters():
            assert _rel(p.detach() - params[n], ref_params[n] - params[n]) \
                < 1e-4, (i, n)


def test_cli_trains_a_tasnet(tmp_path, monkeypatch):
    """`run.train --mode tasnet` (the model's widths made tiny): one epoch,
    one JSON line with a finite loss and held-out SI-SNR; the checkpoint
    options are refused."""
    import functools
    import json

    from dl4ss_tpu_torch.models import dprnn
    from dl4ss_tpu_torch.run import train
    monkeypatch.setattr(dprnn, "DPRNNConfig", functools.partial(
        DPRNNConfig, filters=8, bottleneck=8, hidden=8, blocks=1, chunk=50,
        hop=25))
    metrics = tmp_path / "m.jsonl"
    argv = ["--preset", "synth_tiny", "--device", "cpu", "--mode", "tasnet",
            "--epochs", "1", "--epoch-size", "1", "--set",
            "max_len_seconds=0.1", "--metrics", str(metrics)]
    state = train.main(argv)
    assert state.model.cfg.hidden == 8
    assert state.step == 1
    line = json.loads(metrics.read_text().splitlines()[-1])
    assert torch.isfinite(torch.tensor([line["loss"], line["si_sdr"]])).all()
    with pytest.raises(SystemExit, match="writes no checkpoint"):
        train.main(argv + ["--checkpoint-dir", str(tmp_path / "ck")])
