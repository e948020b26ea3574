"""The port's query encoders, query trainer and their data (ROADMAP P12)
against the JAX package's on the CPU: `conv2d` with XLA's SAME padding
(asymmetric at strides 4, 3, 2), the speech, image and 48x48 conv-trunk
video queries, one query train step (video and image) and the query eval
step from the same parameters and batch, the MNIST glyphs and IDX files,
the lip-frame banks, and the video and image-query CLIs."""

import gzip
import os
import shutil
import struct
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data import mnist as jmnist
from dl4ss_tpu.data import video as jvideo
from dl4ss_tpu.data.synth import featurize as jax_featurize
from dl4ss_tpu.data.synth import make_synthetic_bank as jax_bank
from dl4ss_tpu.data.synth import sample_mixtures as jax_sample
from dl4ss_tpu.models import common as jcommon
from dl4ss_tpu.models import query as jquery
from dl4ss_tpu.run import common as jrun_common
from dl4ss_tpu.train import query_trainer as jqt
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data import mnist as tmnist
from dl4ss_tpu_torch.data import video as tvideo
from dl4ss_tpu_torch.models import common as tcommon
from dl4ss_tpu_torch.models import query as tquery
from dl4ss_tpu_torch.run import common as trun_common
from dl4ss_tpu_torch.train import query_trainer as tqt
from dl4ss_tpu_torch.weights import (export_jax_params, flatten_tree,
                                     load_jax_params)
from torch_step_parity import assert_step_matches, jax_step, torch_step

SMALL = dict(hidden_units=16, embedding_size=8, max_len_seconds=0.5,
             num_speakers=6, batch_size=2, num_layers=1, encoder_layers=1,
             use_pallas_rnn=False, use_pallas_stft=False,
             use_pallas_maskhead=False)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(name, **over):
    over = {**SMALL, **over}
    return jax_preset(name).replace(**over), preset(name).replace(**over)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("size,kernel,stride", [
    (48, 5, 4), (12, 3, 3), (4, 3, 2), (28, 3, 1), (17, 3, 2)])
def test_conv2d_same_padding_matches_jax(size, kernel, stride):
    """XLA's SAME rule, ceil(in / s) out and the odd pad at the end: the
    video trunk's three strided convs at 48x48 and the image query's."""
    rng = np.random.default_rng(size)
    p = jcommon.conv_init(jax.random.PRNGKey(size), 3, 4, kernel, kernel)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    ref = jcommon.conv2d(p, jnp.asarray(x), (stride, stride), "SAME")
    conv = load_jax_params(tcommon.Conv2d(3, 4, kernel, kernel,
                                          device="cpu"), _np_tree(p))
    ours = tcommon.conv2d(conv, torch.as_tensor(x), (stride, stride), "SAME")
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def test_same_pads_of_the_video_trunk():
    assert [tcommon.same_pads(48, 5, 4), tcommon.same_pads(12, 3, 3),
            tcommon.same_pads(4, 3, 2)] == [(0, 1), (0, 0), (0, 1)]


def test_speech_query_matches_jax():
    """BiLSTM(E/2) x num_layers + the masked mean-pool (some frames masked
    out, one item fully): 1e-5."""
    cfg_j, cfg_t = _cfgs("cocktail_debug", num_layers=2)
    p = jquery.init_speech_query(jax.random.PRNGKey(0), cfg_j)
    q = load_jax_params(tquery.SpeechQuery(cfg_t, device="cpu"), _np_tree(p))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, cfg_j.freq_bins)).astype(np.float32)
    mask = rng.random((3, 11)) > 0.3
    mask[2] = False
    ref = jquery.apply_speech_query(p, jnp.asarray(x), jnp.asarray(mask))
    ours = tquery.apply_speech_query(q, torch.as_tensor(x),
                                     torch.as_tensor(mask))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    np.testing.assert_allclose(
        tquery.masked_mean_pool(torch.as_tensor(x)).numpy(),
        np.asarray(jquery.masked_mean_pool(jnp.asarray(x))), atol=1e-6)


def test_image_query_matches_jax():
    cfg_j, cfg_t = _cfgs("multimodal_image")
    p = jquery.init_image_query(jax.random.PRNGKey(1), cfg_j)
    q = load_jax_params(tquery.ImageQuery(cfg_t, device="cpu"), _np_tree(p))
    x = np.random.default_rng(1).random((3, 28, 28, 1)).astype(np.float32)
    ref = jquery.apply_image_query(p, jnp.asarray(x))
    ours = tquery.apply_image_query(q, torch.as_tensor(x))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def test_conv_trunk_video_query_matches_jax():
    """48x48 frames through the SAME convs at strides 4, 3, 2 (pads (0, 1),
    (0, 0), (0, 1)), the BiLSTM over the frames, the last step: logits and
    query within 1e-5."""
    cfg_j, cfg_t = _cfgs("grid_video", num_layers=2)
    p = jquery.init_video_query(jax.random.PRNGKey(2), cfg_j,
                                frame_hw=(48, 48))
    q = load_jax_params(tquery.VideoQuery(cfg_t, frame_hw=(48, 48),
                                          device="cpu"), _np_tree(p))
    x = np.random.default_rng(2).random((2, 3, 48, 48, 3)).astype(
        np.float32)
    ref = jquery.apply_video_query(p, jnp.asarray(x))
    ours = tquery.apply_video_query(q, torch.as_tensor(x))
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                   atol=1e-5)


def _query_setup(query_source, seed=0):
    name = "grid_video" if query_source == "video" else "multimodal_image"
    cfg_j, cfg_t = _cfgs(name)
    state_j = jqt.create_query_state(jax.random.PRNGKey(seed), cfg_j,
                                     query_source)
    state_t = tqt.create_query_state(cfg_t, seed, query_source,
                                     device="cpu")
    load_jax_params(state_t.model, _np_tree(state_j.params))
    bank = jnp.asarray(jax_bank(seed, cfg_j.num_speakers, 2, cfg_j.max_len))
    b = jax_sample(jax.random.PRNGKey(seed + 1), bank, cfg_j)
    feats = jax_featurize(b, cfg_j)
    idx = np.asarray(b.spk_idx)
    if query_source == "video":
        frames = jvideo.synthetic_frame_bank(cfg_j.num_speakers, 2, 3,
                                             (48, 48), seed=seed)
        feats["query_video"] = frames[idx, 1]
    else:
        imgs, labels = jmnist.load_mnist(None, fallback_per_digit=4)
        feats["query_image"] = jmnist.digit_query_bank(
            imgs, labels, cfg_j.num_speakers)[idx, 0]
    feats = {k: np.array(v) for k, v in feats.items()}
    return cfg_j, state_j, cfg_t, state_t, feats


@pytest.mark.parametrize("query_source", ["video", "image"])
def test_query_train_step_matches_jax(query_source):
    """One query train step from the same parameters and batch: the losses
    (mask, the video logits' speaker CE) and grad norm within 1e-5, every
    leaf's gradient within 1e-5 relative L2, and every parameter's update
    within 1e-3 relative L2 on the elements whose gradient lies outside
    the round-off (tests/torch_step_parity.py), at seed 0."""
    cfg_j, state_j, cfg_t, state_t, feats = _query_setup(query_source)
    before = dict(flatten_tree(_np_tree(state_j.params)))
    (new_j, met_j), grads_j = jax_step(
        jqt, lambda: jqt.make_query_train_step(cfg_j, query_source),
        state_j, {k: jnp.asarray(v) for k, v in feats.items()})
    (new_t, met_t), grads_t = torch_step(
        lambda: tqt.make_query_train_step(cfg_t, query_source), state_t,
        {k: torch.as_tensor(v) for k, v in feats.items()})
    keys = ("loss", "mask_loss", "grad_norm") + (
        ("query_ce",) if query_source == "video" else ())
    assert set(keys) <= set(met_t)
    for key in keys:
        assert abs(float(met_t[key]) - float(met_j[key])) \
            <= 1e-5 * abs(float(met_j[key])), key
    assert_step_matches(before, new_j.params, new_t.model, grads_j, grads_t)


def test_query_eval_step_matches_jax():
    cfg_j, state_j, cfg_t, state_t, feats = _query_setup("video", seed=2)
    ref = jqt.make_query_eval_step(cfg_j)(
        state_j.params, {k: jnp.asarray(v) for k, v in feats.items()})
    ours = tqt.make_query_eval_step(cfg_t)(
        state_t.model, {k: torch.as_tensor(v) for k, v in feats.items()})
    np.testing.assert_allclose(ours["si_sdr"].numpy(),
                               np.asarray(ref["si_sdr"]), atol=1e-5)
    np.testing.assert_array_equal(ours["perm"].numpy(),
                                  np.asarray(ref["perm"]))


def test_synthetic_glyphs_and_digit_bank_equal_jax():
    imgs, labels = tmnist.load_mnist(None, fallback_per_digit=5, seed=3)
    ref_i, ref_l = jmnist.load_mnist(None, fallback_per_digit=5, seed=3)
    np.testing.assert_array_equal(imgs, ref_i)
    np.testing.assert_array_equal(labels, ref_l)
    np.testing.assert_array_equal(
        tmnist.digit_query_bank(imgs, labels, 13),
        jmnist.digit_query_bank(ref_i, ref_l, 13))


def test_idx_files_are_read_as_jax_reads_them(tmp_path):
    """A directory holding train IDX files (one gzipped) is read instead of
    the glyphs; both packages return the same arrays."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (7, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 7, dtype=np.uint8)
    with open(tmp_path / "train-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 7, 28, 28) + images.tobytes())
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 0x801, 7) + labels.tobytes())
    (tmp_path / "train-labels-idx1-ubyte").write_bytes(
        gzip.decompress((tmp_path / "train-labels-idx1-ubyte.gz")
                        .read_bytes()))
    got = tmnist.load_mnist(str(tmp_path))
    ref = jmnist.load_mnist(str(tmp_path))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], labels.astype(np.int64))
    np.testing.assert_array_equal(tmnist._read_idx(
        tmp_path / "train-labels-idx1-ubyte.gz"), labels)


def test_frame_banks_equal_jax(tmp_path):
    """The synthetic lips for a seed, and a GRID-style tree of PNG frame
    directories (a short clip repeats its last frame), as JAX reads them;
    run.common's frame geometry and bank."""
    from PIL import Image
    np.testing.assert_array_equal(
        tvideo.synthetic_frame_bank(3, 2, 4, (16, 16), seed=5),
        jvideo.synthetic_frame_bank(3, 2, 4, (16, 16), seed=5))
    rng = np.random.default_rng(5)
    for spk in ("s1", "s2"):
        for clip, n in (("c1", 3), ("c2", 1)):
            d = tmp_path / spk / clip
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (20, 24, 3),
                                             dtype=np.uint8)).save(
                    d / f"{i:03d}.png")
    got, idx2spk = tvideo.speaker_frame_bank(str(tmp_path), 2, (16, 16))
    ref, _ = jvideo.speaker_frame_bank(str(tmp_path), 2, (16, 16))
    assert got.shape == (2, 2, 2, 16, 16, 3) and idx2spk == {0: "s1",
                                                            1: "s2"}
    np.testing.assert_array_equal(got, ref)
    args = SimpleNamespace(video_trunk="conv", frame_size=16, frames=2,
                           video_root=str(tmp_path))
    cfg_j, cfg_t = _cfgs("grid_video", num_speakers=2)
    assert trun_common.frame_hw(args) == (16, 16)
    assert trun_common.frame_hw(SimpleNamespace(
        video_trunk="inception")) == (299, 299)
    np.testing.assert_array_equal(
        trun_common.load_frame_bank(cfg_t, args, (16, 16), 0),
        jrun_common.load_frame_bank(cfg_j, args, (16, 16), 0))
    with pytest.raises(SystemExit, match="pair"):
        trun_common.load_frame_bank(cfg_t.replace(num_speakers=3), args,
                                    (16, 16), 0)


def test_video_files_without_ffmpeg_are_refused(tmp_path, monkeypatch):
    """A clip given as a video file needs ffmpeg to extract its frames;
    where ffmpeg is absent the bank says so instead of running it."""
    assert tvideo.ffmpeg_available() == (shutil.which("ffmpeg") is not None)
    (tmp_path / "s1").mkdir()
    (tmp_path / "s1" / "clip.mpg").write_bytes(b"\0")
    monkeypatch.setattr(tvideo, "ffmpeg_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs ffmpeg"):
        tvideo.speaker_frame_bank(str(tmp_path), 2)
    assert not os.path.exists(tmp_path / ".frames_cache" / "s1" / "clip")


CLI = ["--device", "cpu", "--seed", "0", "--utts", "2", "--set",
       "hidden_units=16", "--set", "embedding_size=6", "--set",
       "max_len_seconds=0.25", "--set", "batch_size=2", "--set",
       "num_speakers=5", "--set", "num_layers=1", "--set",
       "encoder_layers=1", "--epochs", "1", "--epoch-size", "2"]


@pytest.mark.parametrize("argv", [
    ["--preset", "grid_video", "--mode", "video", "--frame-size", "24"],
    ["--preset", "multimodal_image", "--mode", "image-query"]],
    ids=["video", "image-query"])
def test_query_mode_clis(tmp_path, argv):
    """run.train --mode video (synthetic lips) and --mode image-query (the
    glyphs): two steps, a finite dev SI-SDR, a checkpoint that restores."""
    import json

    from dl4ss_tpu_torch.run import train
    metrics, ck = tmp_path / "m.jsonl", tmp_path / "ck"
    state = train.main([*argv, *CLI, "--metrics", str(metrics),
                        "--checkpoint-dir", str(ck)])
    rec = json.loads(metrics.read_text().splitlines()[-1])
    assert state.step == 2 and rec["step"] == 2
    assert np.isfinite([rec["loss"], rec["si_sdr"]]).all()
    assert ("query_ce" in rec) == (argv[3] == "video")
    assert sorted(os.listdir(ck)) == ["cfg.json", "step_2.pt"]
    resumed = train.main([*argv, *CLI, "--checkpoint-dir", str(ck),
                          "--resume"])
    assert resumed.step == 2
