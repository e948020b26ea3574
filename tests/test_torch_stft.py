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
from dl4ss_tpu.ops.pallas_stft import pallas_masked_istft, pallas_stft_features
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.ops import stft as tstft
from dl4ss_tpu_torch.ops import stft_kernels as tk
from dl4ss_tpu_torch.ops import windows as twin

# dl4ss_tpu.ops re-exports a function `stft` that shadows the submodule
jstft = importlib.import_module("dl4ss_tpu.ops.stft")

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
