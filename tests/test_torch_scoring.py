"""The port's scoring against the JAX package on the CPU: the overlap-save
correlation and convolution, BSS-Eval (against the float64 oracle and the
JAX implementation), the gain decomposition and NSDR, the oracle-mask
bounds, the wav export's names and the directory scorer. Inputs are made
from a numpy seed; signals are short (1,600-2,000 samples, 32-64 taps)."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.eval import bss_eval as jax_bss
from dl4ss_tpu.eval.oracle import oracle_mask_sisdr as jax_oracle
from dl4ss_tpu.eval.wav_export import export_batch_outputs as jax_export
from dl4ss_tpu.run import score as jax_score
from dl4ss_tpu.data.wavio import write_wav
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.eval import bss_eval
from dl4ss_tpu_torch.eval.oracle import oracle_mask_sisdr
from dl4ss_tpu_torch.eval.wav_export import export_batch_outputs
from dl4ss_tpu_torch.ops.xcorr import ola_conv, xcorr
from dl4ss_tpu_torch.run import score

# the module: dl4ss_tpu.ops re-exports a function of the same name
jax_xcorr = importlib.import_module("dl4ss_tpu.ops.xcorr")


def _direct_xcorr(a, b, lo, hi):
    out = np.zeros((b.shape[0], a.shape[0], hi - lo + 1))
    for bi in range(b.shape[0]):
        for ai in range(a.shape[0]):
            for li, lag in enumerate(range(lo, hi + 1)):
                u0, u1 = max(0, -lag), min(a.shape[1], b.shape[1] - lag)
                if u1 > u0:
                    out[bi, ai, li] = a[ai, u0:u1] @ b[bi, u0 + lag:u1 + lag]
    return out


@pytest.mark.parametrize("lo,hi,nb", [(0, 63, 700), (-63, 63, 700),
                                      (-127, 0, 700), (-5, 200, 700),
                                      (-10, 10, 1300)])
def test_xcorr_matches_jax_and_the_direct_sum(lo, hi, nb):
    """Within 1e-3 of the direct float64 sum and of JAX's matmul-DFT
    version (f32 FFTs of 1,024 points on both sides)."""
    rng = np.random.default_rng(hi - lo)
    a = rng.standard_normal((2, 700)).astype(np.float32)
    b = rng.standard_normal((3, nb)).astype(np.float32)
    got = xcorr(torch.as_tensor(a), torch.as_tensor(b), lo, hi).numpy()
    want = _direct_xcorr(a.astype(np.float64), b.astype(np.float64), lo, hi)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(
        got, np.asarray(jax_xcorr.xcorr(jnp.asarray(a), jnp.asarray(b), lo,
                                        hi)), atol=2e-3)
    # leading batch dimensions: each item as alone
    batched = xcorr(torch.as_tensor(np.stack([a, a[::-1]])),
                    torch.as_tensor(np.stack([b, b])), lo, hi)
    torch.testing.assert_close(batched[0], torch.as_tensor(got))


@pytest.mark.parametrize("sum_channels", [True, False])
def test_ola_conv_matches_jax_and_numpy(sum_channels):
    rng = np.random.default_rng(4)
    sigs = rng.standard_normal((2, 3000)).astype(np.float32)
    kern = rng.standard_normal((3, 2, 64)).astype(np.float32)
    got = ola_conv(torch.as_tensor(sigs), torch.as_tensor(kern),
                   sum_channels=sum_channels).numpy()
    per = np.stack([[np.convolve(sigs[a].astype(np.float64), kern[j, a])
                     for a in range(2)] for j in range(3)])
    want = per.sum(1) if sum_channels else per
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(
        got, np.asarray(jax_xcorr.ola_conv(jnp.asarray(sigs),
                                           jnp.asarray(kern),
                                           sum_channels=sum_channels)),
        atol=1e-3)


def _toy_sources(rng, n=1600):
    t = np.arange(n) / 8000.0
    s1 = np.sin(2 * np.pi * 400 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    s2 = np.sign(np.sin(2 * np.pi * 97 * t)) * 0.7
    s2 = s2 + 0.05 * rng.standard_normal(n)
    return np.stack([s1, s2])


def _estimates(rng, ref, swap):
    mix = ref.sum(axis=0)
    est = np.stack([0.8 * ref[0] + 0.2 * mix, 0.9 * ref[1] + 0.1 * mix])
    est = est + 0.03 * rng.standard_normal(ref.shape)
    return est[::-1].copy() if swap else est


@pytest.mark.parametrize("swap", [False, True])
def test_bss_eval_sources_matches_oracle_and_jax(swap):
    """Within 0.2 dB of the float64 oracle and of JAX's, with the same
    permutation (tests/test_eval.py's bar), alone and batched."""
    rng = np.random.default_rng(7)
    refs = [_toy_sources(rng) for _ in range(2)]
    ests = [_estimates(rng, r, swap) for r in refs]
    ours = bss_eval.bss_eval_sources(
        torch.as_tensor(np.stack(refs), dtype=torch.float32),
        torch.as_tensor(np.stack(ests), dtype=torch.float32), flen=64)
    for i, (ref, est) in enumerate(zip(refs, ests)):
        sdr, sir, sar, perm = bss_eval.bss_eval_sources_numpy(ref, est, 64)
        want = jax_bss.bss_eval_sources(jnp.asarray(ref, jnp.float32),
                                        jnp.asarray(est, jnp.float32),
                                        flen=64)
        assert list(perm) == ([1, 0] if swap else [0, 1])
        np.testing.assert_array_equal(ours.perm[i].numpy(), perm)
        np.testing.assert_array_equal(ours.perm[i].numpy(), want.perm)
        for got, oracle, jx in ((ours.sdr[i], sdr, want.sdr),
                                (ours.sir[i], sir, want.sir),
                                (ours.sar[i], sar, want.sar)):
            np.testing.assert_allclose(got.numpy(), oracle, atol=0.2)
            np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=0.2)
    one = bss_eval.bss_eval_sources(
        torch.as_tensor(refs[0], dtype=torch.float32),
        torch.as_tensor(ests[0], dtype=torch.float32), flen=64)
    torch.testing.assert_close(one.sdr, ours.sdr[0], atol=1e-4, rtol=0)
    fixed = bss_eval.bss_eval_sources(
        torch.as_tensor(refs[0], dtype=torch.float32),
        torch.as_tensor(ests[0], dtype=torch.float32), flen=64,
        permute=False)
    assert fixed.perm.tolist() == [0, 1]


def test_bss_gain_and_nsdr_match_jax_and_the_oracle():
    """BSS-Eval 2.0: each metric within 0.05 dB of the float64 oracle and
    1e-3 dB of JAX's; NSDR of the mixture itself is 0, a dead padded
    channel changes nothing."""
    rng = np.random.default_rng(8)
    ref = np.stack([_toy_sources(rng), _toy_sources(rng)])     # (2, 2, N)
    est = (0.8 * ref[:, 0] + 0.3 * ref[:, 1]
           + 0.05 * rng.standard_normal(ref[:, 0].shape))
    mix = ref.sum(axis=1)
    t = {k: torch.as_tensor(v, dtype=torch.float32)
         for k, v in (("ref", ref), ("est", est), ("mix", mix))}
    res = bss_eval.bss_eval_gain(t["ref"], t["est"], target_index=0)
    want = jax_bss.bss_eval_gain(jnp.asarray(ref, jnp.float32),
                                 jnp.asarray(est, jnp.float32))
    for b in range(2):
        oracle = bss_eval.bss_crit_numpy(
            *bss_eval.bss_decomp_gain_numpy(est[b], 0, ref[b]))
        for got, o in zip((res.sdr, res.sir, res.sar), oracle):
            np.testing.assert_allclose(float(got[b]), o, atol=0.05)
    for got, jx in zip(res[:3], want[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=1e-3)
    got_r, got_ns = bss_eval.gain_nsdr(t["est"], t["mix"], t["ref"])
    jx_r, jx_ns = jax_bss.gain_nsdr(jnp.asarray(est, jnp.float32),
                                    jnp.asarray(mix, jnp.float32),
                                    jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got_ns.numpy(), np.asarray(jx_ns), atol=1e-3)
    _, ns_mix = bss_eval.gain_nsdr(t["mix"], t["mix"], t["ref"])
    np.testing.assert_allclose(ns_mix.numpy(), 0.0, atol=1e-4)
    dead = torch.cat([t["ref"], torch.zeros_like(t["ref"][:, :1])], dim=1)
    res3, _ = bss_eval.gain_nsdr(t["est"], t["mix"], dead,
                                 live=torch.tensor([[1., 1., 0.]] * 2))
    torch.testing.assert_close(res3.sdr, got_r.sdr, atol=1e-3, rtol=0)
    assert bss_eval.nsdr(torch.tensor(3.0), torch.tensor(1.0)) == 2.0


@pytest.mark.parametrize("kind", ["iam", "irm"])
def test_oracle_mask_sisdr_matches_jax(kind):
    """Within 1e-3 dB of JAX's, live-weighted and not."""
    rng = np.random.default_rng(9)
    over = dict(max_len_seconds=0.25)
    cfg_j = jax_preset("synth_tiny").replace(**over)
    cfg_t = preset("synth_tiny").replace(**over)
    src = rng.uniform(-0.5, 0.5, (3, 2, cfg_t.max_len)).astype(np.float32)
    src[2, 1] = 0.0
    live = np.array([[1, 1], [1, 1], [1, 0]], bool)
    mix = src.sum(1)
    for lv in (None, live):
        got = oracle_mask_sisdr(torch.as_tensor(mix), torch.as_tensor(src),
                                cfg_t, kind=kind,
                                live=None if lv is None
                                else torch.as_tensor(lv))
        want = jax_oracle(jnp.asarray(mix), jnp.asarray(src), cfg_j,
                          kind=kind,
                          live=None if lv is None else jnp.asarray(lv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_wav_export_names_and_bytes_equal_jax(tmp_path):
    """The batch_output contract: the same files with the same bytes,
    with dead channels, more references than estimates, and the recursive
    peel's own names."""
    rng = np.random.default_rng(10)
    mix = rng.standard_normal((2, 400)).astype(np.float32) * 0.2
    pred = rng.standard_normal((2, 2, 400)).astype(np.float32) * 0.2
    real = rng.standard_normal((2, 3, 400)).astype(np.float32) * 0.2
    names = [["011", "022", "033"], ["044", "055", "066"]]
    live = np.array([[True, True, True], [True, False, True]])
    kw = dict(real_wavs=real, live=live, idx_offset=4,
              pred_names=[["022", "011"], ["066", "044"]])
    n_t = export_batch_outputs(tmp_path / "port", mix, pred, pred + 0.01,
                               names, **kw)
    n_j = jax_export(tmp_path / "jax", mix, pred, pred + 0.01, names, **kw)
    files = sorted(os.listdir(tmp_path / "port"))
    assert n_t == n_j == len(files) and files == sorted(
        os.listdir(tmp_path / "jax"))
    assert "4_022_pre.wav" in files and "5_055_realTrue.wav" not in files
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes())


def _write_dir(d, rng, n_mix=3):
    t = np.arange(2000) / 8000.0
    for i in range(n_mix):
        refs = np.stack([0.4 * np.sin(2 * np.pi * (220 + 40 * i + 170 * c)
                                      * t) for c in range(2)])
        refs = refs + 0.05 * rng.standard_normal(refs.shape)
        ests = refs[::-1] + 0.05 * rng.standard_normal(refs.shape)
        for c in range(2):
            write_wav(d / f"{i}_spk{c}_realTrue.wav", refs[c], 8000)
            write_wav(d / f"{i}_spk{c}_pre.wav", ests[c], 8000)
        write_wav(d / f"{i}_True_mix.wav", refs.sum(0), 8000)
    # a group of one estimate and two references (the repeat trick)
    write_wav(d / "9_spk0_realTrue.wav", refs[0], 8000)
    write_wav(d / "9_spk1_realTrue.wav", refs[1], 8000)
    write_wav(d / "9_spk0_pre.wav", ests[1], 8000)


def test_score_dir_matches_jax_and_is_chunk_invariant(tmp_path):
    """The mean SDR and NSDR of one written directory within 0.2 dB of the
    JAX scorer's, every mixture's SDR too; scoring in chunks of 1 or 200
    mixtures gives the same numbers (1e-4 dB)."""
    _write_dir(tmp_path, np.random.default_rng(11))
    ours = score.score_dir(str(tmp_path), flen=32, with_nsdr=True,
                           verbose=False, device="cpu")
    ref = jax_score.score_dir(str(tmp_path), flen=32, with_nsdr=True,
                              verbose=False)
    assert ours["n_mixtures"] == ref["n_mixtures"] == 4
    assert ours["sdr"].shape == (8,) and ours["mean_sdr"] > 5.0
    np.testing.assert_allclose(ours["mean_sdr"], ref["mean_sdr"], atol=0.2)
    np.testing.assert_allclose(ours["mean_nsdr"], ref["mean_nsdr"], atol=0.2)
    for idx in ref["per_mix"]:
        # sorted: the repeat trick's two equal estimates tie on SIR, and
        # round-off picks either permutation
        np.testing.assert_allclose(np.sort(ours["per_mix"][idx]),
                                   np.sort(ref["per_mix"][idx]), atol=0.2)
    one = score.score_dir(str(tmp_path), flen=32, with_nsdr=True,
                          verbose=False, chunk=1, device="cpu")
    np.testing.assert_allclose(one["sdr"], ours["sdr"], atol=1e-4)
    np.testing.assert_allclose(one["mean_nsdr"], ours["mean_nsdr"],
                               atol=1e-4)


def test_score_dir_pad_silent_keeps_the_real_estimates(tmp_path):
    """3 estimates against 2 references: skipped without --pad-silent;
    with it the two real estimates are kept (bss_test.py:47-51), as JAX's
    scorer keeps them."""
    rng = np.random.default_rng(12)
    t = np.arange(2000) / 8000.0
    refs = np.stack([0.4 * np.sin(2 * np.pi * f * t) for f in (220, 390)])
    refs = refs + 0.05 * rng.standard_normal(refs.shape)
    noisy = refs + 0.02 * rng.standard_normal(refs.shape)
    ests = np.stack([noisy[1], 0.3 * rng.standard_normal(2000), noisy[0]])
    for c in range(2):
        write_wav(tmp_path / f"0_spk{c}_realTrue.wav", refs[c], 8000)
    for c in range(3):
        write_wav(tmp_path / f"0_spk{c}_pre.wav", ests[c], 8000)
    assert score.score_dir(str(tmp_path), flen=32, verbose=False,
                           device="cpu")["n_mixtures"] == 0
    ours = score.score_dir(str(tmp_path), flen=32, pad_silent=True,
                           verbose=False, device="cpu")
    ref = jax_score.score_dir(str(tmp_path), flen=32, pad_silent=True,
                              verbose=False)
    assert ours["n_mixtures"] == 1 and ours["mean_sdr"] > 10.0
    np.testing.assert_allclose(ours["mean_sdr"], ref["mean_sdr"], atol=0.2)
