"""The Cocktail memory configuration against the benchmark's plain
reference (`benchmark/reference/memory.py`), on seeded random weights at
small sizes on the CPU: three memory steps with a speaker written twice
in a batch (losses, every gradient leaf, the Nadam update, the memory's
rows and ages), the step's operation count, and the
`cocktail.train_memory` cell run whole through the harness at a small
size, a sound run correct and a planted fault in the memory write
caught."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import registry  # noqa: E402
from benchmark.harness.program import (port_config,  # noqa: E402
                                       reference_config)
from benchmark.reference import memory as ref_memory  # noqa: E402
from benchmark.traffic.bank import make_bank  # noqa: E402
from benchmark.traffic.mixing import Batch  # noqa: E402
from dl4ss_tpu_torch.data.synth import (MixtureBatch,  # noqa: E402
                                        featurize, linear_target_mags)
from dl4ss_tpu_torch.models import memory as port_memory  # noqa: E402
from dl4ss_tpu_torch.train.memory_trainer import (  # noqa: E402
    create_memory_state, make_memory_train_step)

CPU = torch.device("cpu")
SMALL = {"hidden_units": 8, "embedding_size": 6, "num_speakers": 5,
         "max_len_seconds": 0.25, "batch_size": 4}
# each batch's target speakers: the first writes speaker 3 twice, the
# third writes speaker 0 three times and the unk row once
TARGETS = [[3, 1, 3, 4], [2, 0, 4, 1], [0, 5, 0, 0]]


def _config() -> dict:
    file = registry.load_json("configs", "cocktail")
    file["config"] = dict(file["config"], **SMALL)
    file["derived"] = {"max_len": 2000, "freq_bins": 129, "num_frames": 16}
    return file


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _batches(cfg) -> list:
    """Three batches of 2-speaker mixtures whose first speakers are
    TARGETS (the sources come from the bank's rows of other speakers
    too: the write does not care whose voice a row holds)."""
    bank = make_bank(5, cfg.num_speakers + 1, 2, cfg.max_len, cfg.frame_rate,
                     CPU)
    g = torch.Generator().manual_seed(9)
    out = []
    for targets in TARGETS:
        spk = torch.tensor([[t, (t + 1) % (cfg.num_speakers + 1)]
                            for t in targets])
        utt = torch.randint(0, 2, spk.shape, generator=g)
        sources = bank[spk, utt] * torch.tensor([1.0, 0.7])[:, None]
        out.append(Batch(sources.sum(dim=1), sources, spk))
    return out


def _feats(batch: Batch, cfg) -> dict:
    """The memory trainer's batch of `batch`, as `memory_batch` makes
    it."""
    mb = MixtureBatch(batch.mix, batch.sources, batch.spk_idx,
                      torch.ones(batch.spk_idx.shape))
    f = featurize(mb, cfg)
    mix_mag, target_mag = linear_target_mags(f, mb, cfg)
    return {"mix_feas": f["mix_feas"], "mix_mag": mix_mag,
            "spk_id": batch.spk_idx[:, 0], "clean_feas": f["src_feas"][:, 0],
            "target_mag": target_mag}


def test_memory_steps_match_the_reference():
    """Three steps from the same weights and an empty memory: each step's
    loss, each step's gradient of every leaf as autograd hands it over,
    the parameters after each Nadam update, and the memory's rows and
    ages after each step's two writes (a speaker written two and three
    times in one batch; the unk row)."""
    file = _config()
    c, cfg = reference_config(file), port_config(file)
    assert cfg.optimizer == "nadam" and cfg.unk_spk
    params = ref_memory.make_params(c, 11, CPU)
    state = create_memory_state(cfg, 0, "speech", device="cpu")
    state.model.load_state_dict(params, strict=True)
    step = make_memory_train_step(cfg, "speech")
    grads = {}
    for n, p in state.model.named_parameters():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach()))
    ref_params = {k: v.clone() for k, v in params.items()}
    opt = ref_memory.optimizer(ref_params, c)
    memory = ref_memory.empty_memory(c, CPU)
    assert memory.vectors.shape == state.memory.vectors.shape == (6, 3, 6)
    for i, batch in enumerate(_batches(cfg)):
        grads.clear()
        _, metrics = step(state, _feats(batch, cfg))
        loss, ref_grads, memory = ref_memory.memory_step(
            ref_params, opt, memory, batch, c)
        assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5), i
        assert set(grads) == set(ref_grads)
        for n, want in ref_grads.items():
            assert float(want.norm()) > 0.0, (i, n)
            assert _rel(grads[n], want) < 1e-4, (i, n)
        for n, p in state.model.named_parameters():
            assert _rel(p.detach() - params[n], ref_params[n] - params[n]) \
                < 1e-4, (i, n)
        assert torch.equal(state.memory.age, memory.age), i
        assert _rel(state.memory.vectors, memory.vectors) < 1e-5, i
    # the persistent write's counts: the in-graph write's memory is read
    # and dropped
    assert memory.age[:, ref_memory.VOICE].tolist() == [4, 2, 1, 2, 2, 1]
    assert int(memory.age[:, 1:].abs().sum()) == 0


def test_count_of_a_step():
    """A B=16 step at the configuration's widths: the encoder's and the
    voiceprint's four recurrent layers (twice more in the backward), and
    the forward's products counted by hand."""
    c = reference_config(registry.load_json("configs", "cocktail"))
    layers = registry.load_module("flops", "cocktail")
    count = registry.load_module("drivers", "train_memory").count(
        layers, c, 16)
    b, t, f, h, e, half = 16, 313, 129, 300, 50, 25
    lstm = 2 * 2 * b * t * 4
    forward = (lstm * h * (f + h) + lstm * h * (2 * h + h)
               + lstm * half * (f + half) + lstm * half * (2 * half + half)
               + 2 * b * t * 2 * h * f * e + 2 * b * t * f * e * e
               + 2 * b * e * e + 2 * b * t * f * e + 2 * 104 * b * 2 * half)
    assert layers.memory_model(c, b).model == pytest.approx(forward,
                                                            rel=1e-12)
    assert len(count.recurrence) == 8
    assert [o for o, _ in count.recurrence[:4]] == [
        lstm * h * h, lstm * h * h, lstm * half * half, lstm * half * half]
    assert count.model > 3 * forward


TINY = {"config": {"hidden_units": 16, "embedding_size": 8,
                   "num_speakers": 8, "max_len_seconds": 0.25,
                   "batch_size": 4},
        "derived": {"max_len": 2000, "num_frames": 16}}


def run_small() -> dict:
    """The cell at a small size on a seed whose first two batches each
    write one target twice, so that the three compared steps see the
    accumulation."""
    from benchmark.run import execute
    return execute("cocktail.train_memory", 20261019, 1.0, False, CPU,
                   registry.manifest(), TINY,
                   dict(batch=4, warmup_units=1, trace_units=1,
                        bank={"utterances": 4}))["result"]


def test_sound_run_is_correct():
    res = run_small()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {
        "loss1_gap", "loss_gap", "grad_gap", "grad_diff", "change_gap",
        "window_loss_gap", "memory_gap"}


def _no_accumulation(state, spk_idx, vec, slot=port_memory.SLOT_SPEECH,
                     mode="keras", mesh=None):
    """The write with each speaker's last vector of the batch alone, as a
    scatter that overwrites would leave it."""
    last = {int(s): i for i, s in enumerate(spk_idx.tolist())}
    keep = torch.tensor(sorted(last.values()))
    return real_write(state, spk_idx[keep], vec[keep], slot, mode, mesh)


real_write = port_memory.memory_write_slot
FAULTS = {
    # the persistent write after the update left out: the memory stays
    # empty, and every step's in-graph write starts from nothing
    "no_persistent_write": lambda state, spk_idx, vec, slot=0, mode="keras",
    mesh=None: (state if not vec.requires_grad
                else real_write(state, spk_idx, vec, slot, mode, mesh)),
    # the torch generation's write in place of the Keras one
    "torch_write_mode": lambda state, spk_idx, vec, slot=0, mode="keras",
    mesh=None: real_write(state, spk_idx, vec, slot, "torch", mesh),
    "duplicates_overwritten": _no_accumulation,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_memory_write_is_caught(fault, monkeypatch):
    """Each fault turns `correct` false, and `memory_gap` with it."""
    from dl4ss_tpu_torch.train import memory_trainer
    monkeypatch.setattr(memory_trainer, "memory_write_slot", FAULTS[fault])
    res = run_small()
    assert not res["correct"]
    failing = {k for k, v in res["checks"].items()
               if not v["value"] <= v["limit"]}
    assert "memory_gap" in failing, res["checks"]
