"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without a CUDA device (the kernels have no CPU or
interpret mode; the CPU suite tests the plain versions against JAX). The
shapes are ragged on purpose — batch, time, hidden and embedding widths
that are not multiples of the kernels' tiles. On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the GPU machine
need not have; this file imports torch and numpy only.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    from dl4ss_tpu_torch import resolve_device
    return resolve_device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)


@pytest.mark.parametrize("b,n,length,hop", [(1, 3001, 256, 128),
                                           (3, 777, 64, 16),
                                           (2, 1000, 256, 96)])
@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
def test_k1_stft_features(dev, b, n, length, hop, feat_dtype):
    from dl4ss_tpu_torch.ops import stft_kernels as k
    from dl4ss_tpu_torch.ops.stft import reflect_pad
    x = _t(np.random.default_rng(0).uniform(-1, 1, (b, n)), dev)
    xpad = reflect_pad(x, length // 2).contiguous()
    got = k.stft_features_cuda(xpad, length, hop, "hann", feat_dtype)
    ref = k.stft_features_plain(xpad, length, hop, "hann", feat_dtype)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(), atol=1e-4,
                                   rtol=0 if g.dtype == torch.float32
                                   else 2 ** -8)


@pytest.mark.parametrize("t,b,h", [(7, 1, 37), (5, 17, 300), (3, 2, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_k2_gru_fwd(dev, t, b, h, dtype, tol):
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(1)
    s = 1 / np.sqrt(h)
    xp = _t(rng.standard_normal((t, 2, b, 3 * h)), dev, dtype)
    wh = _t(rng.uniform(-s, s, (2, h, 3 * h)), dev, dtype)
    bhn = _t(rng.uniform(-s, s, (2, 1, h)), dev)
    torch.testing.assert_close(k.gru_scan_cuda(xp, wh, bhn).float(),
                               k.gru_scan_plain(xp, wh, bhn).float(),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("b,t,d,f,e,k", [(1, 70, 24, 13, 5, 3),
                                         (2, 129, 600, 129, 50, 2),
                                         (3, 5, 40, 7, 16, 1),
                                         (2, 33, 37, 10, 20, 2)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k3_maskhead_fwd(dev, b, t, d, f, e, k, out_dtype):
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    rng = np.random.default_rng(2)
    s = 1 / np.sqrt(d)
    args = (_t(rng.uniform(-1, 1, (b, t, d)), dev, torch.bfloat16),
            _t(rng.uniform(-s, s, (d, f * e)), dev, torch.bfloat16),
            _t(rng.uniform(-s, s, f * e), dev),
            _t(rng.standard_normal((b, k, e)), dev, torch.bfloat16),
            f, e, out_dtype)
    got = m.fused_dot_masks_cuda(*args)
    assert got.shape == (b, k, t, f) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(),
                               m.fused_dot_masks_plain(*args).float(),
                               atol=2e-2, rtol=0)


def test_k3_packs_w_once_per_version(dev):
    """W is packed on its first use, reused while it is unchanged, and
    repacked after an in-place update."""
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    rng = np.random.default_rng(5)
    b, t, d, f, e, k = 2, 20, 48, 9, 12, 2
    h = _t(rng.uniform(-1, 1, (b, t, d)), dev, torch.bfloat16)
    w = _t(rng.uniform(-0.2, 0.2, (d, f * e)), dev)
    bias = _t(rng.uniform(-0.2, 0.2, f * e), dev)
    q = _t(rng.standard_normal((b, k, e)), dev, torch.bfloat16)
    args = (h, w, bias, q, f, e, torch.float32)
    before = cuda_lib.LAUNCHES["maskhead_pack"]
    m.fused_dot_masks_cuda(*args)
    m.fused_dot_masks_cuda(*args)
    assert cuda_lib.LAUNCHES["maskhead_pack"] == before + 1
    w.mul_(-1.0)
    got = m.fused_dot_masks_cuda(*args)
    assert cuda_lib.LAUNCHES["maskhead_pack"] == before + 2
    torch.testing.assert_close(got, m.fused_dot_masks_plain(*args),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("b,k,t,length,hop", [(1, 2, 9, 256, 128),
                                              (2, 3, 13, 64, 16),
                                              (2, 1, 6, 256, 96)])
@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bfloat16])
def test_k4_masked_istft(dev, b, k, t, length, hop, mask_dtype):
    from dl4ss_tpu_torch.ops import stft_kernels as s
    rng = np.random.default_rng(3)
    f = length // 2 + 1
    re, im = (_t(rng.standard_normal((b, t, f)), dev) for _ in range(2))
    masks = _t(rng.uniform(0, 1, (b, k, t, f)), dev, mask_dtype)
    args = (re, im, masks, length, hop, "hann")
    torch.testing.assert_close(s.masked_ola_cuda(*args),
                               s.masked_ola_plain(*args), atol=1e-4,
                               rtol=0)


def test_wrappers_route_cuda_tensors_to_the_kernels(dev):
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.models import init_separator
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.serve import separate_waveforms
    cfg = preset("synth_tiny").replace(use_pallas_rnn=True,
                                       use_pallas_stft=True,
                                       use_pallas_maskhead=True)
    model = init_separator(cfg, torch.Generator().manual_seed(0), dev)
    wav = _t(np.random.default_rng(4).uniform(-1, 1, (2, cfg.max_len)), dev)
    spk = torch.tensor([[0, 1], [2, 3]], device=dev)
    before = dict(cuda_lib.LAUNCHES)
    out = separate_waveforms(model, wav, cfg, spk, length=cfg.max_len)
    assert out.shape == (2, 2, cfg.max_len)
    for name in cuda_lib.KERNELS:
        assert cuda_lib.LAUNCHES[name] > before.get(name, 0), name
    plain = separate_waveforms(
        model, wav, cfg.replace(use_pallas_rnn=False, use_pallas_stft=False,
                                use_pallas_maskhead=False), spk,
        length=cfg.max_len)
    assert float((out - plain).norm() / plain.norm()) < 2e-2

