"""K1 (STFT features) and K4 (masked iSTFT): CUDA kernels and plain versions.

Ports `pallas_stft_features` and `pallas_masked_istft`
(dl4ss_tpu/ops/pallas_stft.py). Each public wrapper sends a CPU tensor to
the plain PyTorch version and a CUDA tensor to the hand-written kernel
(csrc/stft_features.cu, csrc/masked_istft.cu); there is no fallback from
one to the other. The `*_plain` and `*_cuda` halves are public so that a
check can hold one against the other on the same inputs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dl4ss_tpu_torch.ops import cuda_lib
from dl4ss_tpu_torch.ops.stft import (_trim, dft_matrix, dsp_tables,
                                      idft_matrix, overlap_add, reflect_pad)
from dl4ss_tpu_torch.ops.windows import get_window

_FEAT_DTYPES = (torch.float32, torch.bfloat16)


def _bins(frame_length: int) -> int:
    return frame_length // 2 + 1


# ---------------------------------------------------------------------------
# K1: STFT features
# ---------------------------------------------------------------------------


def stft_features(x: torch.Tensor, frame_length: int = 256,
                  frame_shift: int = 128, window: str = "hann",
                  center: bool = True, feat_dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N) f32 -> (mag (B, T, F) in feat_dtype, re, im (B, T, F) f32).

    One pass emits the magnitude feature and the spectrum halves that
    `masked_istft` resynthesises from, so the serving path never forms a
    phasor. The reflect pad is a torch op before the kernel, as in JAX.
    The kernel has no backward (nor has the JAX one): on the card an input
    that requires grad raises rather than giving a detached result.
    """
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("stft_features: the STFT feature kernel (K1) has "
                           "no backward; pass an input that does not "
                           "require grad")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"stft_features wants (B, N) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if center:
        x = reflect_pad(x, frame_length // 2)
    x = x.contiguous()
    if x.is_cuda:
        return stft_features_cuda(x, frame_length, frame_shift, window,
                                  feat_dtype)
    return stft_features_plain(x, frame_length, frame_shift, window,
                               feat_dtype)


def stft_features_plain(xpad: torch.Tensor, frame_length: int,
                        frame_shift: int, window: str, feat_dtype):
    """K1's plain version on the padded signal (B, Np)."""
    tab = dsp_tables(frame_length, window, xpad.device)
    bins = _bins(frame_length)
    frames = xpad.unfold(-1, frame_length, frame_shift) * tab.win
    re = torch.matmul(frames, tab.dft[:, :bins])
    im = torch.matmul(frames, tab.dft[:, bins:])
    return torch.sqrt(re * re + im * im).to(feat_dtype), re, im


@functools.lru_cache(maxsize=16)
def _dft_halves(frame_length: int, device: torch.device):
    """cos and -sin tables, each (L, F) contiguous."""
    dft = torch.as_tensor(dft_matrix(frame_length), device=device)
    bins = _bins(frame_length)
    return dft[:, :bins].contiguous(), dft[:, bins:].contiguous()


def stft_features_cuda(xpad: torch.Tensor, frame_length: int,
                       frame_shift: int, window: str, feat_dtype):
    """K1 on the card: csrc/stft_features.cu on the padded signal (B, Np)."""
    cuda_lib.check(xpad, "x", (torch.float32,))
    if feat_dtype not in _FEAT_DTYPES:
        raise TypeError(f"feat_dtype must be one of {_FEAT_DTYPES}")
    b, n_pad = xpad.shape
    t = 1 + (n_pad - frame_length) // frame_shift
    f = _bins(frame_length)
    win = dsp_tables(frame_length, window, xpad.device).win
    cos_t, sin_t = _dft_halves(frame_length, xpad.device)
    mag = torch.empty((b, t, f), dtype=feat_dtype, device=xpad.device)
    re = torch.empty((b, t, f), dtype=torch.float32, device=xpad.device)
    im = torch.empty_like(re)
    cuda_lib.launch("stft_features", xpad.device, xpad, win, cos_t, sin_t,
                    mag, re, im, b, n_pad, t, frame_length, frame_shift, f,
                    int(feat_dtype == torch.bfloat16))
    return mag, re, im


# ---------------------------------------------------------------------------
# K4: masked iSTFT
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _ola_norm(t: int, frame_length: int, frame_shift: int, window: str,
              device: torch.device) -> torch.Tensor:
    """1 / (overlap-added window squares) where nonzero, else 1."""
    win = get_window(window, frame_length)
    wsq = np.zeros((t - 1) * frame_shift + frame_length, np.float32)
    for ti in range(t):
        wsq[ti * frame_shift:ti * frame_shift + frame_length] += win ** 2
    norm = np.where(wsq > 1e-10, 1.0 / np.maximum(wsq, 1e-10), 1.0)
    return torch.as_tensor(norm.astype(np.float32), device=device)


def masked_istft(re: torch.Tensor, im: torch.Tensor, masks: torch.Tensor,
                 frame_length: int = 256, frame_shift: int = 128,
                 window: str = "hann", center: bool = True,
                 length: Optional[int] = None) -> torch.Tensor:
    """Resynthesis of K masked channels from the mixture spectrum.

    re/im (B, T, F) mixture spectrum halves, masks (B, K, T, F) real masks
    -> (B, K, length): istft(mask * spec) per channel, the mask multiply,
    iDFT, window and overlap-add fused in one kernel on the card.
    """
    b, k, t, f = masks.shape
    want = (b, t, f)
    if tuple(re.shape) != want or tuple(im.shape) != want:
        raise ValueError(
            f"masked_istft: re/im must be the (B, T, F) mixture spectrum "
            f"matching masks (B, K, T, F)={tuple(masks.shape)}; got "
            f"re={tuple(re.shape)} im={tuple(im.shape)}, expected {want}")
    if f != _bins(frame_length):
        raise ValueError(f"masked_istft: {f} bins, expected "
                         f"{_bins(frame_length)} for L={frame_length}")
    re, im, masks = re.contiguous(), im.contiguous(), masks.contiguous()
    if masks.is_cuda:
        ola = masked_ola_cuda(re, im, masks, frame_length, frame_shift,
                              window)
    else:
        ola = masked_ola_plain(re, im, masks, frame_length, frame_shift,
                               window)
    ola = ola * _ola_norm(t, frame_length, frame_shift, window, ola.device)
    return _trim(ola, t, frame_length, frame_shift, center, length)


def masked_ola_plain(re, im, masks, frame_length: int, frame_shift: int,
                     window: str) -> torch.Tensor:
    """K4's plain version: the raw overlap-add (B, K, (T-1)*hop + L)."""
    tab = dsp_tables(frame_length, window, re.device)
    bins = _bins(frame_length)
    m = masks.float()
    frames = (torch.matmul(m * re[:, None], tab.idft[:bins])
              + torch.matmul(m * im[:, None], tab.idft[bins:])) * tab.win
    return overlap_add(frames, frame_shift)


def masked_ola_cuda(re, im, masks, frame_length: int, frame_shift: int,
                    window: str) -> torch.Tensor:
    """K4 on the card: csrc/masked_istft.cu, the raw overlap-add."""
    b, k, t, f = masks.shape
    cuda_lib.check(re, "re", (torch.float32,), (b, t, f))
    cuda_lib.check(im, "im", (torch.float32,), (b, t, f))
    cuda_lib.check(masks, "masks", _FEAT_DTYPES)
    tab = dsp_tables(frame_length, window, re.device)
    mre, mim = _idft_halves(frame_length, re.device)
    out_len = (t - 1) * frame_shift + frame_length
    out = torch.empty((b, k, out_len), dtype=torch.float32, device=re.device)
    cuda_lib.launch("masked_istft", re.device, re, im, masks, mre, mim,
                    tab.win, out, b, k, t, f, frame_length, frame_shift,
                    out_len, int(masks.dtype == torch.bfloat16))
    return out


@functools.lru_cache(maxsize=16)
def _idft_halves(frame_length: int, device: torch.device):
    """iDFT rows for Re and for Im, each (F, L) contiguous."""
    idft = torch.as_tensor(idft_matrix(frame_length), device=device)
    bins = _bins(frame_length)
    return idft[:bins].contiguous(), idft[bins:].contiguous()
