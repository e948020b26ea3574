"""The audio-visual GRID configuration against the benchmark's plain
reference (`benchmark/reference/inception.py`, `video.py`), on seeded
random weights at small sizes on the CPU: the Inception trunk at its
smallest input, the video query, one query training step; the uint8 lip
frames against their float form; the trunk's operation count; and the
new cells run whole through the harness at a small size, a sound run
correct and a planted fault caught."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import registry  # noqa: E402
from benchmark.harness.program import (port_config,  # noqa: E402
                                       reference_config)
from benchmark.reference import inception as ref_inception  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.reference import video as ref_video  # noqa: E402
from benchmark.traffic.bank import make_bank  # noqa: E402
from benchmark.traffic.frames import make_frames  # noqa: E402
from benchmark.traffic.mixing import replay_batch  # noqa: E402
from dl4ss_tpu_torch.models.inception import (  # noqa: E402
    apply_inception_v3, init_inception_v3)
from dl4ss_tpu_torch.models.query import (  # noqa: E402
    apply_video_query, init_video_query, normalize_frames, video_features)
from dl4ss_tpu_torch.train.query_trainer import (  # noqa: E402
    create_query_state, make_query_train_step, query_batch)

HW = (75, 75)           # the smallest input Inception-v3 takes
CPU = torch.device("cpu")
SMALL = {"hidden_units": 8, "embedding_size": 4, "num_speakers": 5,
         "max_len_seconds": 0.25, "batch_size": 2}


def _config(**overrides) -> dict:
    file = registry.load_json("configs", "grid_video")
    file["config"] = dict(file["config"], **SMALL, **overrides)
    file["derived"] = {"max_len": 2000, "freq_bins": 129, "num_frames": 16}
    return file


def _frames(n: int, t: int, seed: int = 3) -> torch.Tensor:
    return make_frames(seed, n, 1, t, HW, CPU)[:, 0]         # (n, t, H, W, 3)


def _params(c: dict, seed: int = 11) -> dict:
    return ref_video.make_params(c, seed, CPU)


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def test_trunk_matches_the_reference_at_75x75():
    c = reference_config(_config())
    params = _params(c)
    net = init_inception_v3(device="cpu")
    net.load_state_dict(_sub(params, ref_video.TRUNK), strict=True)
    frames = _frames(3, 1)[:, 0]                              # 3 frames
    with torch.no_grad():
        got = apply_inception_v3(net, normalize_frames(frames))[2]
    want = ref_inception.features(
        {k: v.double() for k, v in params.items()}, ref_video.TRUNK, frames)
    assert got.shape == want.shape == (3, 2048)
    assert float(want.std()) > 0.05            # a feature, not a constant
    assert _rel(got, want) < 1e-5


def test_video_query_matches_the_reference():
    file = _config()
    c, cfg = reference_config(file), port_config(file)
    params = _params(c)
    vq = init_video_query(cfg, frame_hw=HW, trunk="inception", device="cpu")
    vq.load_state_dict(_sub(params, "video_query."), strict=True)
    frames = _frames(2, 3)
    with torch.no_grad():
        logits, query = apply_video_query(vq, frames)
        want_l, want_q = ref_video.video_query(
            {k: v.double() for k, v in params.items()}, frames, c)
    assert query.shape == (2, c["embedding_size"])
    assert logits.shape == (2, c["num_speakers"])
    assert _rel(query, want_q) < 1e-5
    assert _rel(logits, want_l) < 1e-5


def test_query_train_step_matches_the_reference():
    """One step at B=2, 3 frames a clip: the loss, every leaf's gradient
    as autograd hands it over, and every leaf's update."""
    file = _config()
    c, cfg = reference_config(file), port_config(file)
    params = _params(c)
    state = create_query_state(cfg, 0, "video", video_trunk="inception",
                               frame_hw=HW, device="cpu")
    state.model.load_state_dict(params, strict=True)
    bank = make_bank(5, cfg.num_speakers, 3, cfg.max_len, cfg.frame_rate,
                     CPU)
    frames = make_frames(6, cfg.num_speakers, 2, 3, HW, CPU)
    state.generator = torch.Generator().manual_seed(7)
    grads = {}
    for n, p in state.model.named_parameters():
        p.register_hook(lambda g, n=n: grads.setdefault(n, g.detach()))
    feats = query_batch(state.generator, bank, cfg, "query_video", frames)
    _, metrics = make_query_train_step(cfg, "video")(state, feats)

    g = torch.Generator().manual_seed(7)
    batch = replay_batch(g, bank, c)
    clip = torch.randint(0, 2, batch.spk_idx.shape, generator=g)
    ref_params = {k: v.clone() for k, v in params.items()}
    opt = ref_train.Adam(ref_params, ref_train.generator_names(ref_params),
                         c)
    ref_batch = ref_video.VideoBatch(*batch, frames[batch.spk_idx, clip])
    loss, ref_grads = ref_video.query_step(ref_params, opt, ref_batch, c)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5)
    trunk = set(ref_video.trunk_names(params))
    assert not trunk & set(grads)              # the frozen trunk: no grad
    for n, want in ref_grads.items():
        got = grads.get(n, torch.zeros_like(want))
        if n in trunk or float(want.norm()) == 0.0:
            assert float(got.norm()) == 0.0, n
        else:
            assert _rel(got, want) < 1e-4, n
    for n, p in state.model.named_parameters():
        step = ref_params[n] - params[n]
        if n in trunk or float(step.norm()) == 0.0:
            assert torch.equal(p.detach(), params[n]), n
        else:
            assert _rel(p.detach() - params[n], step) < 1e-3, n


def test_uint8_frames_are_their_float_form_bit_for_bit(tmp_path):
    """Every pixel value normalizes as `load_frame_dir` normalizes it;
    a frame tree read as uint8 and normalized on the device equals the
    float bank; the trunks' features of uint8 frames equal those of their
    float form exactly."""
    from PIL import Image

    from dl4ss_tpu_torch.config import preset
    from dl4ss_tpu_torch.data.video import (load_frame_dir,
                                            speaker_frame_bank,
                                            synthetic_frame_bank)
    values = np.arange(256, dtype=np.float32)
    assert torch.equal(normalize_frames(torch.arange(256).to(torch.uint8)),
                       torch.from_numpy(values / 127.5 - 1.0))
    rng = np.random.default_rng(0)
    for spk in ("s1", "s2"):
        d = tmp_path / spk / "c1"
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (20, 24, 3),
                                         dtype=np.uint8)).save(
                d / f"{i:03d}.png")
    u8, _ = speaker_frame_bank(str(tmp_path), 2, (16, 16), dtype=np.uint8)
    f32, _ = speaker_frame_bank(str(tmp_path), 2, (16, 16))
    assert u8.dtype == np.uint8
    assert torch.equal(normalize_frames(torch.from_numpy(u8)),
                       torch.from_numpy(f32))
    assert np.array_equal(load_frame_dir(str(tmp_path / "s1" / "c1"), 2,
                                         (16, 16), normalize=False),
                          u8[0, 0].astype(np.float32))
    from types import SimpleNamespace

    from dl4ss_tpu_torch.run.common import load_frame_bank
    args = SimpleNamespace(video_root=str(tmp_path), frames=2,
                           frame_dtype="uint8")
    two = preset("grid_video").replace(num_speakers=2)
    assert np.array_equal(load_frame_bank(two, args, (16, 16), 0), u8)
    syn = synthetic_frame_bank(2, 1, 2, (16, 16), seed=4, dtype=np.uint8)
    assert syn.dtype == np.uint8 and syn.shape == (2, 1, 2, 16, 16, 3)
    assert np.array_equal(syn, np.round(synthetic_frame_bank(
        2, 1, 2, (16, 16), seed=4) * 255.0).astype(np.uint8))
    cfg = preset("grid_video").replace(**SMALL)
    frames = _frames(3, 1)[:, 0]
    for trunk in ("conv", "inception"):
        vq = init_video_query(cfg, frame_hw=HW, trunk=trunk,
                              generator=torch.Generator().manual_seed(1),
                              device="cpu")
        with torch.no_grad():
            assert torch.equal(video_features(vq, frames), video_features(
                vq, normalize_frames(frames))), trunk


def test_trunk_operations_are_torchvisions():
    """5.71 GMAC a 299x299 frame (torchvision's count for Inception-v3),
    94 convolutions; a B=16 step puts 2,400 frames through them."""
    flops = registry.load_module("flops", "grid_video")
    layers = flops.trunk_layers((299, 299))
    assert len(layers) == 94
    macs = sum(o for _, o, _ in layers) / 2
    assert macs == pytest.approx(5.711e9, rel=1e-3)
    c = reference_config(registry.load_json("configs", "grid_video"))
    ops, _ = flops.trunk(c, 16)
    assert ops == pytest.approx(2400 * 2 * macs, rel=1e-12)
    assert flops.trunk_least_s(c, 16, 67e12, 3.35e12) >= ops / 67e12


TINY = {"config": {"hidden_units": 16, "embedding_size": 8,
                   "num_speakers": 8, "max_len_seconds": 0.25,
                   "batch_size": 4},
        "derived": {"max_len": 2000, "num_frames": 16}}
CELLS = {
    "grid_video.train_inception": (
        {"video": {"frame_hw": list(HW), "frames": 3,
                   "clips_per_speaker": 2}}, {}),
    "torch_multi.train_dp4": ({}, {"dp": 2}),
}


def run_small(cell: str) -> dict:
    from benchmark.run import execute
    config, traffic = CELLS[cell]
    return execute(cell, 20261018, 1.0, False, CPU, registry.manifest(),
                   dict(TINY, **config),
                   dict(traffic, batch=4, warmup_units=1, trace_units=1,
                        bank={"utterances": 4}))["result"]


def _children() -> list:
    """The live processes whose parent is this one."""
    me, out = os.getpid(), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.append(stat.parent.name)
    return out


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    before = set(_children())
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(_children()) <= before          # no rank outlives the run


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_half_batch_left_out_is_caught(cell, monkeypatch):
    from dl4ss_tpu_torch.data import synth
    from dl4ss_tpu_torch.train import query_trainer, steps

    real = synth.featurize

    def half(batch, cfg):
        keep = batch.mix_wav.shape[0] // 2
        return real(type(batch)(*(None if x is None else x[:keep]
                                  for x in batch)), cfg)

    monkeypatch.setattr(synth, "featurize", half)
    monkeypatch.setattr(steps, "featurize", half)
    if cell.startswith("grid_video"):
        real_batch = query_trainer.query_batch

        def half_query(generator, bank, cfg, key, qbank):
            feats = real_batch(generator, bank, cfg, key, qbank)
            keep = feats["mix_feas"].shape[0]
            return dict(feats, **{key: feats[key][:keep]})

        monkeypatch.setattr(query_trainer, "query_batch", half_query)
    res = run_small(cell)
    assert not res["correct"]
    assert not all(c["value"] <= c["limit"] for c in res["checks"].values())
