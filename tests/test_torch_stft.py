"""Port DSP (dl4ss_tpu_torch.ops.stft / stft_kernels) against the JAX
reference, on the CPU. Inputs come from numpy seeds and go to both
packages. The DSP tolerance is 1e-4 absolute: the JAX side runs its DFT
matmuls at Precision.HIGHEST (f32), the port in f32 on the CPU, so the two
differ only in summation order (~1e-6 at these sizes)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu.ops import windows as jwin
from dl4ss_tpu.ops.pallas_stft import (pallas_istft, pallas_istft_ri,
                                       pallas_masked_istft,
                                       pallas_spectral_feature, pallas_stft,
                                       pallas_stft_features, pallas_stft_ri)
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.ops import stft_kernels as tk
from dl4ss_tpu_torch.ops import windows as twin

# both packages' `ops` re-export a function `stft` that shadows the submodule
jstft = importlib.import_module("dl4ss_tpu.ops.stft")
tstft = importlib.import_module("dl4ss_tpu_torch.ops.stft")

ATOL = 1e-4


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _wav(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["hann", "sine", "sqrt_hann", "rect"])
def test_windows_match(name):
    np.testing.assert_array_equal(twin.get_window(name, 256),
                                  jwin.get_window(name, 256))


@pytest.mark.parametrize("length", [256, 32])
def test_dft_matrices_match(length):
    np.testing.assert_array_equal(tstft.dft_matrix(length),
                                  jstft.dft_matrix(length))
    np.testing.assert_array_equal(tstft.idft_matrix(length),
                                  jstft.idft_matrix(length))


@pytest.mark.parametrize("center", [True, False])
def test_stft_matches_jax(center):
    x = _wav(0, (2, 3, 1000))
    ours = tstft.stft(_t(x), center=center)
    ref = jstft.stft(jnp.asarray(x), center=center)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.real.numpy(), _np(ref.real), atol=ATOL)
    np.testing.assert_allclose(ours.imag.numpy(), _np(ref.imag), atol=ATOL)


@pytest.mark.parametrize("window", ["hann", "sqrt_hann"])
def test_istft_matches_jax_and_round_trips(window):
    x = _wav(1, (2, 4000))
    spec = jstft.stft(jnp.asarray(x), window=window)
    ref = jstft.istft(spec, window=window)
    ours = tstft.istft(torch.complex(_t(spec.real), _t(spec.imag)),
                       window=window)
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), x[:, :ours.shape[-1]],
                               atol=2e-4)


def test_reference_length_contract():
    """A 40000-sample utterance resynthesises to exactly 39936 samples,
    and `length` pads or trims, on every iSTFT route."""
    x = _t(_wav(2, (1, 40000)))
    spec = tstft.stft(x)
    assert tuple(spec.shape) == (1, 313, 129)
    assert tstft.istft(spec).shape[-1] == 39936
    assert tstft.istft(spec, length=40000).shape[-1] == 40000
    assert tstft.istft(spec, length=1000).shape[-1] == 1000
    ones = torch.ones((1, 1, 313, 129))
    for n in (None, 40000, 1000):
        got = tk.masked_istft(spec.real, spec.imag, ones, length=n)
        assert got.shape[-1] == (39936 if n is None else n)


def test_overlap_add_matches_jax():
    frames = _wav(3, (2, 9, 32))
    for hop in (16, 12, 32):
        np.testing.assert_allclose(
            tstft.overlap_add(_t(frames), hop).numpy(),
            _np(jstft.overlap_add(jnp.asarray(frames), hop)), atol=1e-6)


def test_magnitude_and_spectral_feature_log_path():
    x = _wav(4, (2, 2000))
    mag, ph = tstft.magnitude_and_phase(tstft.stft(_t(x)))
    jmag, jph = jstft.magnitude_and_phase(jstft.stft(jnp.asarray(x)))
    np.testing.assert_allclose(mag.numpy(), _np(jmag), atol=ATOL)
    np.testing.assert_allclose(ph.real.numpy(), _np(jph.real), atol=ATOL)
    for log in (False, True):
        feat, _ = tstft.spectral_feature(_t(x), log_spectral=log)
        jfeat, _ = jstft.spectral_feature(jnp.asarray(x), log_spectral=log)
        # log features: |X| near zero amplifies the 1e-6 DFT difference
        np.testing.assert_allclose(feat.numpy(), _np(jfeat),
                                   atol=ATOL if not log else 1e-3)


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
def test_k1_plain_matches_pallas_stft_features(feat_dtype):
    """K1's plain version (the wrapper on CPU tensors) against the Pallas
    kernel in interpret mode."""
    x = _wav(5, (2, 1000))
    mag, re, im = tk.stft_features(_t(x), feat_dtype=feat_dtype)
    jdt = jnp.bfloat16 if feat_dtype == torch.bfloat16 else jnp.float32
    jmag, jre, jim = pallas_stft_features(jnp.asarray(x), feat_dtype=jdt)
    assert mag.dtype == feat_dtype and re.dtype == torch.float32
    np.testing.assert_allclose(re.numpy(), _np(jre), atol=ATOL)
    np.testing.assert_allclose(im.numpy(), _np(jim), atol=ATOL)
    # bf16 magnitudes: both round the same f32 value; a 1e-6 difference
    # can flip one bf16 step (2^-8 relative)
    np.testing.assert_allclose(mag.float().numpy(),
                               _np(jmag.astype(jnp.float32)),
                               atol=ATOL, rtol=0 if jdt == jnp.float32
                               else 2 ** -8)


@pytest.mark.parametrize("length", [None, 1100])
def test_k4_plain_matches_pallas_masked_istft(length):
    x = _wav(6, (2, 1000))
    masks = np.random.default_rng(7).uniform(0, 1, (2, 3, 8, 129)).astype(
        np.float32)
    _, jre, jim = pallas_stft_features(jnp.asarray(x))
    ref = pallas_masked_istft(jre, jim, jnp.asarray(masks), length=length)
    ours = tk.masked_istft(_t(jre), _t(jim), _t(masks), length=length)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=ATOL)


def test_k4_rejects_mismatched_spectrum():
    re = torch.zeros((2, 8, 129))
    with pytest.raises(ValueError, match="mixture spectrum"):
        tk.masked_istft(re, re[:1], torch.zeros((2, 1, 8, 129)))


@pytest.mark.parametrize("fused", [False, True])
def test_masked_resynthesis_matches_jax(fused):
    cfg = preset("synth_tiny").replace(use_pallas_stft=fused)
    x = _wav(8, (2, 1000))
    masks = np.random.default_rng(9).uniform(0, 1, (2, 2, 8, 129)).astype(
        np.float32)
    spec = jstft.stft(jnp.asarray(x))
    ref = jstft.masked_resynthesis(spec, jnp.asarray(masks), cfg,
                                   length=1000)
    ours = tstft.masked_resynthesis(_t(spec.real), _t(spec.imag), _t(masks),
                                    cfg, length=1000)
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_masked_resynthesis_grads_match_jax(fused):
    """Gradients w.r.t. the spectrum halves and the masks. The kernel route
    (K4's forward; a backward that recomputes through the plain iSTFT)
    against JAX's custom VJP `_fused_mr_bwd`, and the plain route against
    JAX autodiff of the XLA iSTFT: f32 both sides, 1e-4."""
    import jax
    cfg = preset("synth_tiny").replace(use_pallas_stft=fused)
    rng = np.random.default_rng(10)
    spec = jstft.stft(jnp.asarray(_wav(11, (2, 1000))))
    re, im = _np(spec.real), _np(spec.imag)
    masks = rng.uniform(0, 1, (2, 2, 8, 129)).astype(np.float32)
    cot = rng.standard_normal((2, 2, 1000)).astype(np.float32)

    def loss(r, i, m):
        out = jstft.masked_resynthesis(r + 1j * i, m, cfg, length=1000)
        return jnp.sum(out * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (re, im,
                                                               masks)))
    leaves = [_t(a).requires_grad_() for a in (re, im, masks)]
    out = tstft.masked_resynthesis(*leaves, cfg, length=1000)
    (out * _t(cot)).sum().backward()
    for name, leaf, r in zip(("re", "im", "masks"), leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), _np(r), atol=ATOL,
                                   err_msg=name)


def test_tables_first_built_in_inference_mode_serve_a_backward():
    """The cached DSP tables are ordinary tensors even when a serving call
    under `torch.inference_mode` builds them first: a training step later
    in the same process saves them for its backward."""
    for cached in (tstft.dsp_tables, tk._ola_norm, tk._idft_halves,
                   tk._dft_halves, tk._twiddles):
        cached.cache_clear()
    cfg = preset("synth_tiny").replace(use_pallas_stft=True)
    x = _t(_wav(12, (1, 1000)))
    masks = torch.full((1, 2, 8, 129), 0.5)
    with torch.inference_mode():
        _, re, im = tk.stft_features(x)
        tstft.masked_resynthesis(re, im, masks, cfg, length=1000)
        tstft.istft(tstft.stft(x))
    assert not tstft.dsp_tables(256, "hann", x.device).win.is_inference()
    _, re, im = tk.stft_features(x)
    leaf = masks.clone().requires_grad_()
    for c in (cfg, cfg.replace(use_pallas_stft=False)):
        tstft.masked_resynthesis(re, im, leaf, c, length=1000).sum().backward()
    assert bool(torch.isfinite(leaf.grad).all()) and bool(leaf.grad.any())


# ---------------------------------------------------------------------------
# K9 (packed STFT) and K10 (iSTFT of a packed spectrum)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n,length,hop,window", [(2048, 256, 128, "hann"),
                                                 (1000, 64, 16, "sqrt_hann")])
def test_k9_plain_matches_pallas_stft_ri(center, n, length, hop, window):
    """`stft_ri` on a CPU tensor (K9's plain version) against the Pallas
    kernel in interpret mode, centered and not, and against K1's Re and Im
    on the same signal: 1e-4."""
    x = _wav(20, (3, n))
    ref = pallas_stft_ri(jnp.asarray(x), length, hop, window, center)
    ours = tk.stft_ri(_t(x), length, hop, window, center)
    assert tuple(ours.shape) == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=ATOL)
    _, re, im = tk.stft_features(_t(x), length, hop, window, center)
    torch.testing.assert_close(ours, torch.cat([re, im], dim=-1),
                               atol=1e-6, rtol=0)


def test_k9_complex_wrapper_matches_pallas_stft():
    x = _wav(21, (2, 1500))
    ref = pallas_stft(jnp.asarray(x))
    ours = tk.stft_kernel(_t(x))
    assert ours.dtype == torch.complex64 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.real.numpy(), _np(ref.real), atol=ATOL)
    np.testing.assert_allclose(ours.imag.numpy(), _np(ref.imag), atol=ATOL)


@pytest.mark.parametrize("length", [None, 4000, 1000])
@pytest.mark.parametrize("center", [True, False])
def test_k10_plain_matches_pallas_istft_ri(length, center):
    """`istft_ri` on a CPU tensor (K10's plain version, then the win^2
    normalisation, the trim and the length contract) against the Pallas
    kernel in interpret mode, for the three length cases (default
    (T-1)*hop, zero-padded past it, cut short): 1e-4. The spectrum is a
    signal's own. Uncentered, the first and last 16 samples are divided by
    a win^2 below 1e-3, which amplifies the f32 round-off of either side's
    iDFT: they are held to 1e-2."""
    n = 30 * 128 if center else 30 * 128 + 256
    ri = tk.stft_ri(_t(_wav(22, (2, n))), center=center).numpy()
    assert ri.shape == (2, 31, 258)
    ref = pallas_istft_ri(jnp.asarray(ri), center=center, length=length)
    ours = tk.istft_ri(_t(ri), center=center, length=length)
    want = length or (30 * 128 if center else 30 * 128 + 256)
    assert tuple(ours.shape) == ref.shape == (2, want)
    ours, ref = ours.numpy(), _np(ref)
    if not center:
        edge = np.ones(want, bool)
        edge[16:n - 16] = False
        np.testing.assert_allclose(ours[:, edge], ref[:, edge], atol=1e-2)
        ours, ref = ours[:, ~edge], ref[:, ~edge]
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_k9_k10_round_trip_and_complex_wrapper():
    """K9 then K10 returns the waveform (1e-4), and the complex wrapper
    agrees with `pallas_istft` on the same spectrum."""
    x = _wav(23, (2, 4000))
    spec = tk.stft_kernel(_t(x))
    y = tk.istft_kernel(spec)
    assert tuple(y.shape) == (2, (spec.shape[1] - 1) * 128)
    np.testing.assert_allclose(y.numpy(), x[:, :y.shape[1]], atol=ATOL)
    ref = pallas_istft(jnp.asarray(spec.numpy()))
    np.testing.assert_allclose(y.numpy(), _np(ref), atol=ATOL)
    y2 = tk.istft_ri(tk.stft_ri(_t(x)), length=4000)
    np.testing.assert_allclose(y2.numpy()[:, :3900], x[:, :3900], atol=ATOL)


@pytest.mark.parametrize("call", [
    lambda: tk.stft_ri(torch.zeros((1, 1000)), 256, 96),
    lambda: tk.istft_ri(torch.zeros((1, 5, 258)), 256, 96),
    lambda: tk.masked_istft(torch.zeros((1, 5, 129)), torch.zeros((1, 5, 129)),
                            torch.zeros((1, 2, 5, 129)), 256, 96),
], ids=["stft_ri", "istft_ri", "masked_istft"])
def test_k9_k10_need_hop_dividing_frame_length(call):
    with pytest.raises(ValueError, match="frame_length % frame_shift"):
        call()


def test_k4_refuses_the_hop_that_the_jax_kernel_refuses():
    """`pallas_masked_istft` asserts frame_length % frame_shift == 0; the
    port's `masked_istft` refuses the same shape (above) on every route,
    rather than return a waveform where JAX fails."""
    z = jnp.zeros((1, 5, 129), jnp.float32)
    with pytest.raises(AssertionError):
        pallas_masked_istft(z, z, jnp.zeros((1, 2, 5, 129)), 256, 96)
    cfg = preset("synth_tiny").replace(use_pallas_stft=True, frame_shift=96)
    with pytest.raises(ValueError, match="frame_length % frame_shift"):
        tstft.masked_resynthesis(torch.zeros((1, 5, 129)),
                                 torch.zeros((1, 5, 129)),
                                 torch.zeros((1, 2, 5, 129)), cfg)


# ---------------------------------------------------------------------------
# The FFT body of K1 and K9 (csrc/stft_tile.cuh) through its CPU mirror
# ---------------------------------------------------------------------------

MIRROR_SHAPES = [(32, 16), (32, 8), (64, 32), (64, 16), (256, 128),
                 (256, 64), (256, 96), (512, 256), (512, 128)]


def _padded(x, length, center):
    x = _t(x)
    return tstft.reflect_pad(x, length // 2) if center else x


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("length,hop", MIRROR_SHAPES)
def test_fft_mirror_matches_plain_and_jax(length, hop, center):
    """`stft_fft_mirror` (the CUDA FFT body's steps in plain torch: even/odd
    packing, table twiddles, Stockham radix-4/2 stages, split) against K9's
    plain version and against the JAX STFT on the same signal: 1e-4 max
    abs, the DSP bar. The JAX side is the Pallas kernel in interpret mode
    where it takes the shape (hop divides L), the XLA STFT otherwise."""
    x = _wav(30, (2, 5 * length + 77))
    xin = _padded(x, length, center)
    got = tk.stft_fft_mirror(xin, length, hop, "hann")
    plain = tk.stft_ri_plain(xin, length, hop, "hann")
    assert got.shape == plain.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    if length % hop == 0:
        ref = _np(pallas_stft_ri(jnp.asarray(x), length, hop, "hann", center))
    else:
        spec = jstft.stft(jnp.asarray(x), length, hop, "hann", center)
        ref = np.concatenate([_np(spec.real), _np(spec.imag)], axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("length,hop", [(32, 8), (64, 32), (256, 128),
                                        (512, 128)])
def test_fft_mirror_matches_pallas_stft_features(length, hop):
    """The mirror's halves and their magnitude against K1's TPU kernel in
    interpret mode (mag, Re, Im): 1e-4."""
    x = _wav(31, (2, 4 * length + 31))
    got = tk.stft_fft_mirror(_padded(x, length, True), length, hop,
                             "sqrt_hann")
    bins = length // 2 + 1
    re, im = got[..., :bins], got[..., bins:]
    jmag, jre, jim = pallas_stft_features(jnp.asarray(x), length, hop,
                                          "sqrt_hann")
    np.testing.assert_allclose(re.numpy(), _np(jre), atol=ATOL)
    np.testing.assert_allclose(im.numpy(), _np(jim), atol=ATOL)
    np.testing.assert_allclose(torch.sqrt(re * re + im * im).numpy(),
                               _np(jmag), atol=ATOL)


def test_fft_mirror_is_closer_to_float64_than_the_matmul():
    """An FFT sums log2 L terms per output where the matmul sums L: at the
    serving shape the mirror lands within 5e-6 of a float64 DFT, no further
    from it than the plain version is."""
    x = _wav(32, (2, 4000))
    xin = _padded(x, 256, True)
    frames = xin.double().unfold(-1, 256, 128) * _t(
        twin.get_window("hann", 256)).double()
    n = np.arange(256)[:, None] * np.arange(129)[None, :]
    ang = _t(2.0 * np.pi * n / 256)
    ref = torch.cat([frames @ torch.cos(ang), frames @ -torch.sin(ang)], -1)
    err = float((tk.stft_fft_mirror(xin, 256, 128, "hann") - ref).abs().max())
    plain = float((tk.stft_ri_plain(xin, 256, 128, "hann") - ref).abs().max())
    assert err < 5e-6 and err <= plain


@pytest.mark.parametrize("length", [32, 64, 256, 512, 2048])
def test_twiddle_table_matches_float64(length):
    """The FFT body's one table: (L/2+1, 2) of cos and -sin(2 pi k / L),
    each the float64 value rounded once to f32; its ends are exact."""
    tab = tk.twiddle_table(length)
    assert tab.shape == (length // 2 + 1, 2) and tab.dtype == np.float32
    k = np.arange(length // 2 + 1, dtype=np.float64)
    w = np.exp(-2j * np.pi * k / length)
    np.testing.assert_array_equal(tab[:, 0], w.real.astype(np.float32))
    np.testing.assert_allclose(tab[:, 1], w.imag, atol=2 ** -24, rtol=0)
    np.testing.assert_array_equal(tab[0], [1.0, 0.0])
    assert tab[-1, 0] == -1.0 and abs(tab[-1, 1]) < 1e-15
    # W^(L/4) = -i: the table's middle row
    assert abs(tab[length // 4, 0]) < 1e-15 and tab[length // 4, 1] == -1.0


@pytest.mark.parametrize("length,hop,body", [
    (32, 16, "fft"), (64, 16, "fft"), (256, 128, "fft"), (256, 96, "fft"),
    (256, 256, "fft"), (2048, 512, "fft"), (16, 8, "direct"),
    (4096, 1024, "direct"), (96, 48, "direct"), (1000, 250, "direct"),
    (255, 85, "direct"), (256, 300, "direct")])
def test_stft_body_shape_rule(length, hop, body):
    """Which of the tile's two bodies a shape takes on the card: the FFT
    body for a power-of-two L in [32, 2048] with hop <= L, else the direct
    body. Every preset's frame length takes the FFT body."""
    assert tk.stft_body(length, hop) == body
    if body == "direct":
        with pytest.raises(ValueError, match="power-of-two"):
            tk.stft_fft_mirror(torch.zeros((1, 3 * max(length, hop))), length,
                               hop, "hann")


def test_every_preset_takes_the_fft_body():
    from dl4ss_tpu_torch.config import preset_names
    for name in preset_names():
        cfg = preset(name)
        assert tk.stft_body(cfg.frame_length, cfg.frame_shift) == "fft", name


def test_ops_exports_the_kernel_wrappers():
    """`dl4ss_tpu_torch.ops` exports the kernel wrappers by name, as the JAX
    package exports its pallas_* functions, and, as in JAX, `ops.stft`,
    `ops.istft` and `ops.xcorr` are the functions, not their modules:
    `from dl4ss_tpu_torch.ops import stft` is callable and equals
    `dl4ss_tpu.ops.stft` on the same input (1e-4)."""
    import dl4ss_tpu.ops as jops
    from dl4ss_tpu_torch import ops
    from dl4ss_tpu_torch.ops import istft, stft, xcorr
    for name in ("stft_features", "masked_istft", "stft_ri", "stft_kernel",
                 "istft_ri", "istft_kernel", "spectral_feature_kernel",
                 "gru_scan", "lstm_scan"):
        assert callable(getattr(ops, name)), name
    assert (stft, istft) == (tstft.stft, tstft.istft) == (ops.stft, ops.istft)
    assert xcorr is importlib.import_module("dl4ss_tpu_torch.ops.xcorr").xcorr
    x = _wav(4, (2, 1000))
    ours, ref = stft(_t(x)), jops.stft(jnp.asarray(x))
    np.testing.assert_allclose(ours.real.numpy(), _np(ref.real), atol=ATOL)
    np.testing.assert_allclose(ours.imag.numpy(), _np(ref.imag), atol=ATOL)
    np.testing.assert_allclose(istft(ours).numpy(), _np(jops.istft(ref)),
                               atol=ATOL)


def test_spectral_feature_kernel_matches_pallas_spectral_feature():
    """The port's counterpart of `pallas_spectral_feature` (K1's plain
    version here) against the Pallas kernel in interpret mode: |STFT| and
    the (B, T, F, 2) packed spectrum, 1e-4."""
    x = _wav(5, (2, 1000))
    mag, ri = tk.spectral_feature_kernel(_t(x))
    ref_mag, ref_ri = pallas_spectral_feature(jnp.asarray(x))
    assert tuple(ri.shape) == ref_ri.shape == (2, 8, 129, 2)
    np.testing.assert_allclose(mag.numpy(), _np(ref_mag), atol=ATOL)
    np.testing.assert_allclose(ri.numpy(), _np(ref_ri), atol=ATOL)


@pytest.mark.parametrize("window", ["hann", "sqrt_hann"])
def test_bf16_stft_and_istft_match_jax(window):
    """`stft(dtype=bfloat16)` and `istft(dtype=bfloat16)`: frames, window
    and DFT tables in bf16 (each product rounded to bf16 where JAX rounds
    it), the DFTs accumulated in f32. Against JAX's bf16 output on the same
    input the bf16 operands are the same values, so only the f32 summation
    order differs: 2e-5 on the spectrum (peak |X| ~ 35 here; 9.5e-6 seen)
    and 2e-6 on the waveform (9.5e-7 seen). bf16's own error, against the
    f32 transform and against the input, stays within 1e-2 relative L2
    (0.3-0.4% seen)."""
    x = _wav(6, (2, 2000))
    ref = jstft.stft(jnp.asarray(x), window=window, dtype=jnp.bfloat16)
    ours = tstft.stft(_t(x), window=window, dtype=torch.bfloat16)
    assert ours.dtype == torch.complex64
    for part in ("real", "imag"):
        np.testing.assert_allclose(getattr(ours, part).numpy(),
                                   _np(getattr(ref, part)), atol=2e-5)
    f32 = tstft.stft(_t(x), window=window)
    assert float((ours - f32).abs().norm() / f32.abs().norm()) < 1e-2
    wav_ref = jstft.istft(ref, window=window, dtype=jnp.bfloat16)
    wav = tstft.istft(ours, window=window, dtype=torch.bfloat16)
    assert wav.dtype == torch.float32
    np.testing.assert_allclose(wav.numpy(), _np(wav_ref), atol=2e-6)
    x_cut = _t(x[:, :wav.shape[-1]])
    assert float((wav - x_cut).norm() / x_cut.norm()) < 1e-2
    wav_ref = jstft.istft(ref, window=window, dtype=jnp.bfloat16)
    wav = tstft.istft(ours, window=window, dtype=torch.bfloat16)
    assert wav.dtype == torch.float32
    np.testing.assert_allclose(wav.numpy(), _np(wav_ref), atol=2e-5)
    np.testing.assert_allclose(wav.numpy(), x[:, :wav.shape[-1]], atol=5e-2)


# ---------------------------------------------------------------------------
# The FFT body of K4 and K10 (csrc/istft_tile.cuh) through its CPU mirror
# ---------------------------------------------------------------------------

# frames per block of the FFT body (csrc/istft_tile.cuh ISTFT_FFT_HOPS): T
# of 1, FR and FR + 1 take the edges of its tiles
FR = 8


def _spectrum(seed, shape):
    """Random Re and Im halves, nonzero in Im of bins 0 and L/2 too: every
    route must ignore those two values."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _wsq(t, length, hop, window):
    """The overlap-added window squares, float64, as the Pallas wrappers
    build them."""
    win = np.asarray(jwin.get_window(window, length), np.float64)
    wsq = np.zeros((t - 1) * hop + length)
    for ti in range(t):
        wsq[ti * hop:ti * hop + length] += win ** 2
    return wsq


def _pallas_ola(out, t, length, hop, window):
    """A Pallas iSTFT's output (center=False, default length) with its
    window-square normalisation undone: the kernel's raw overlap-add, up to
    one f32 rounding of the normalisation (where win^2 sums to less than
    1e-10 both sides are ~0)."""
    return _np(out).astype(np.float64) * _wsq(t, length, hop, window)


ISTFT_SHAPES = [(32, 32, "sqrt_hann"), (32, 16, "hann"), (64, 16, "hann"),
                (256, 128, "hann"), (256, 64, "sqrt_hann"),
                (512, 128, "hann")]


@pytest.mark.parametrize("t", [1, FR, FR + 1, 313])
@pytest.mark.parametrize("length,hop,window", ISTFT_SHAPES)
def test_istft_fft_mirror_matches_plain_and_pallas_istft_ri(length, hop,
                                                            window, t):
    """`istft_fft_mirror` (the CUDA inverse FFT body's steps in plain torch:
    inverse split, table twiddles, Stockham stages on conj Z, window / L,
    overlap-add in ascending t) against K10's plain version and against the
    Pallas kernel in interpret mode, R = L/hop of 1, 2 and 4: 1e-4 max abs,
    the DSP bar."""
    re, im = _spectrum(40, (2, t, length // 2 + 1))
    got = tk.istft_fft_mirror(_t(re), _t(im), length, hop, window)
    ri = np.concatenate([re, im], axis=-1)
    plain = tk.istft_ola_plain(_t(ri), length, hop, window)
    assert got.shape == plain.shape == (2, (t - 1) * hop + length)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    ref = _pallas_ola(pallas_istft_ri(jnp.asarray(ri), length, hop, window,
                                      center=False), t, length, hop, window)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,hop,t", [(32, 32, 1), (64, 16, FR),
                                          (256, 128, FR + 1),
                                          (256, 128, 313), (256, 64, 313),
                                          (512, 128, FR + 1)])
def test_istft_fft_mirror_matches_plain_and_pallas_masked_istft(
        length, hop, t, mask_dtype):
    """The mirror with masks (K4's order of work: the mask multiplied in as
    the bins are read) against K4's plain version and against
    `pallas_masked_istft` in interpret mode, f32 and bf16 masks (both sides
    read the same bf16 values): 1e-4."""
    f = length // 2 + 1
    re, im = _spectrum(41, (2, t, f))
    masks = torch.as_tensor(np.random.default_rng(42).uniform(
        0, 1, (2, 3, t, f)).astype(np.float32)).to(mask_dtype)
    got = tk.istft_fft_mirror(_t(re), _t(im), length, hop, "hann", masks)
    plain = tk.masked_ola_plain(_t(re), _t(im), masks, length, hop, "hann")
    assert got.shape == plain.shape == (2, 3, (t - 1) * hop + length)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    jmasks = jnp.asarray(masks.float().numpy())
    if mask_dtype == torch.bfloat16:
        jmasks = jmasks.astype(jnp.bfloat16)
    ref = _pallas_ola(pallas_masked_istft(jnp.asarray(re), jnp.asarray(im),
                                          jmasks, length, hop, "hann",
                                          center=False), t, length, hop,
                      "hann")
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("length", [32, 64, 256, 2048])
def test_istft_fft_mirror_scale_is_numpys_irfft(length):
    """One frame under a rectangular window with hop = L is the inverse real
    DFT itself: the mirror's 1/L scale, its handling of the DC and Nyquist
    bins (whose imaginary parts numpy's irfft, like idft_matrix, ignores)
    and its sign conventions against float64 `numpy.fft.irfft`."""
    re, im = _spectrum(43, (3, 1, length // 2 + 1))
    got = tk.istft_fft_mirror(_t(re), _t(im), length, length, "rect")
    ref = np.fft.irfft(re.astype(np.float64) + 1j * im, n=length)
    np.testing.assert_allclose(got.numpy(), ref[:, 0], atol=1e-6, rtol=0)


def test_istft_fft_mirror_is_closer_to_float64_than_the_matmul():
    """An FFT sums log2 L terms per output where the matmul sums L: at the
    serving shape (L=256, hop=128, T=313) the mirror lands within 2e-6 of a
    float64 irfft overlap-add, closer than the plain version does."""
    t, length, hop = 313, 256, 128
    re, im = _spectrum(44, (2, t, length // 2 + 1))
    win = np.asarray(twin.get_window("hann", length), np.float64)
    frames = np.fft.irfft(re.astype(np.float64) + 1j * im, n=length) * win
    ref = np.zeros((2, (t - 1) * hop + length))
    for ti in range(t):
        ref[:, ti * hop:ti * hop + length] += frames[:, ti]
    got = tk.istft_fft_mirror(_t(re), _t(im), length, hop, "hann").numpy()
    plain = tk.istft_ola_plain(_t(np.concatenate([re, im], -1)), length, hop,
                               "hann").numpy()
    err, err_plain = np.abs(got - ref).max(), np.abs(plain - ref).max()
    assert err < 2e-6 and err < err_plain, (err, err_plain)


@pytest.mark.parametrize("length,hop,body", [
    (32, 32, "fft"), (32, 16, "fft"), (32, 4, "fft"), (256, 128, "fft"),
    (256, 64, "fft"), (256, 32, "fft"), (2048, 256, "fft"),
    (2048, 2048, "fft"), (256, 96, "direct"), (256, 16, "direct"),
    (32, 2, "direct"), (16, 8, "direct"), (4096, 1024, "direct"),
    (96, 48, "direct"), (1000, 250, "direct"), (256, 300, "direct")])
def test_istft_body_shape_rule(length, hop, body):
    """Which of the inverse tile's two bodies a shape takes on the card:
    the FFT body for a power-of-two L in [32, 2048] whose hop divides it
    at most 8 times, else the direct body; the mirror refuses what the
    rule sends to the direct body."""
    assert tk.istft_body(length, hop) == body
    if body == "direct":
        z = torch.zeros((1, 2, length // 2 + 1))
        with pytest.raises(ValueError, match="power-of-two"):
            tk.istft_fft_mirror(z, z, length, hop, "hann")


def test_every_preset_takes_the_inverse_fft_body():
    """Every preset's K4 and K10 shape takes the inverse FFT body, as its
    K1 and K9 shape takes the forward one."""
    from dl4ss_tpu_torch.config import preset_names
    for name in preset_names():
        cfg = preset(name)
        assert tk.istft_body(cfg.frame_length, cfg.frame_shift) == "fft", name
