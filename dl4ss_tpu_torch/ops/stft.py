"""STFT / iSTFT as plain PyTorch matmuls (the port of `dl4ss_tpu/ops/stft.py`).

Same conventions as the JAX reference: librosa-style center=True reflect
padding, periodic Hann by default, spectra laid out (frames, bins), and the
iSTFT's window-square normalisation. A centered 5 s / 8 kHz utterance gives
313 frames x 129 bins, and the round trip returns (T-1)*hop = 39936 samples.

The DSP runs in full f32: the DFT matrices are built in float64 and cast,
and on CUDA `resolve_device` turns TF32 off, so the matmuls here match the
reference's `Precision.HIGHEST` to ~1e-6.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dl4ss_tpu_torch.ops.windows import get_window


# ---------------------------------------------------------------------------
# DFT matrices (constants, computed once per L in float64 then cast)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def dft_matrix(frame_length: int) -> np.ndarray:
    """(L, 2F) real matrix: frames @ M -> [Re | Im] of the rfft."""
    length = frame_length
    bins = length // 2 + 1
    n = np.arange(length)[:, None]
    k = np.arange(bins)[None, :]
    ang = 2.0 * np.pi * n * k / length
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def idft_matrix(frame_length: int) -> np.ndarray:
    """(2F, L) real matrix: [Re | Im] @ M -> time-domain frame (inverse rfft)."""
    length = frame_length
    bins = length // 2 + 1
    n = np.arange(length)[None, :]
    k = np.arange(bins)[:, None]
    ang = 2.0 * np.pi * n * k / length
    scale = np.full((bins, 1), 2.0 / length)
    scale[0] = 1.0 / length
    if length % 2 == 0:
        scale[-1] = 1.0 / length
    return np.concatenate([scale * np.cos(ang), -scale * np.sin(ang)],
                          axis=0).astype(np.float32)


class DspTables(NamedTuple):
    win: torch.Tensor    # (L,) analysis / synthesis window
    dft: torch.Tensor    # (L, 2F) [cos | -sin]
    idft: torch.Tensor   # (2F, L) scaled inverse


def table_cache(fn):
    """`lru_cache` for constant tensors. It builds them with inference mode
    off: a table first made inside a serving call (`torch.inference_mode`)
    would otherwise be an inference tensor, which a later training step in
    the same process could not save for its backward. A table lives as
    long as the process: a captured CUDA graph reads it by its address."""
    @functools.lru_cache(maxsize=None)
    @functools.wraps(fn)
    def cached(*args):
        with torch.inference_mode(False):
            return fn(*args)
    return cached


@table_cache
def dsp_tables(frame_length: int, window: str, device: torch.device
               ) -> DspTables:
    """The f32 DSP constants for one (L, window) on one device, built once."""
    return DspTables(
        torch.as_tensor(get_window(window, frame_length), device=device),
        torch.as_tensor(dft_matrix(frame_length), device=device),
        torch.as_tensor(idft_matrix(frame_length), device=device))


# ---------------------------------------------------------------------------
# Framing / overlap-add
# ---------------------------------------------------------------------------


def num_frames(num_samples: int, frame_length: int, frame_shift: int,
               center: bool = True) -> int:
    padded = num_samples + 2 * (frame_length // 2) if center else num_samples
    return 1 + (padded - frame_length) // frame_shift


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by `pad` on both sides (numpy 'reflect')."""
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def frame_signal(x: torch.Tensor, frame_length: int, frame_shift: int,
                 center: bool = True) -> torch.Tensor:
    """(..., N) -> (..., T, L) strided frames."""
    if center:
        x = reflect_pad(x, frame_length // 2)
    return x.unfold(-1, frame_length, frame_shift)


def overlap_add(frames: torch.Tensor, frame_shift: int) -> torch.Tensor:
    """(..., T, L) -> (..., (T-1)*hop + L) without scatter.

    The frame sequence splits into R = ceil(L/hop) interleaved groups;
    within a group consecutive frames are >= L samples apart, so each group
    is a plain pad + reshape, and the groups sum elementwise.
    """
    *lead, t, length = frames.shape
    hop = frame_shift
    r = -(-length // hop)
    out_len = (t - 1) * hop + length
    t_pad = -(-t // r) * r
    if t_pad != t:
        frames = F.pad(frames, (0, 0, 0, t_pad - t))
    group_stride = r * hop
    full_len = (t_pad - 1) * hop + length + group_stride
    out = None
    for g in range(r):
        grp = frames[..., g::r, :]
        if length < group_stride:
            grp = F.pad(grp, (0, group_stride - length))
        flat = grp.reshape(*lead, -1)
        start = g * hop
        flat = F.pad(flat, (start, full_len - start - flat.shape[-1]))
        out = flat if out is None else out + flat
    return out[..., :out_len]


def _trim(ola: torch.Tensor, t: int, frame_length: int, frame_shift: int,
          center: bool, length: Optional[int]) -> torch.Tensor:
    """Center trim and the length contract shared by every iSTFT path."""
    full = (t - 1) * frame_shift + frame_length
    if center:
        pad = frame_length // 2
        out = ola[..., pad:full - pad]
    else:
        out = ola
    default_len = out.shape[-1]
    if length is None:
        return out
    if length <= default_len:
        return out[..., :length]
    return F.pad(out, (0, length - default_len))


# ---------------------------------------------------------------------------
# STFT / iSTFT
# ---------------------------------------------------------------------------


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in f32 with an f32 result, for operands in any
    float dtype (JAX's preferred_element_type=f32): a product of two bf16
    values is exact in f32, so the upcast operands give the same sums."""
    return torch.matmul(a.float(), b.float())


def stft(x: torch.Tensor, frame_length: int = 256, frame_shift: int = 128,
         window: str = "hann", center: bool = True,
         dtype=torch.float32) -> torch.Tensor:
    """Batched STFT. (..., N) -> complex64 (..., T, F). The frames, the
    window and the DFT table are in `dtype` (their product rounded to it),
    the DFT accumulated in f32."""
    tab = dsp_tables(frame_length, window, x.device)
    frames = frame_signal(x.to(dtype), frame_length, frame_shift, center)
    ri = _f32_product(frames * tab.win.to(dtype), tab.dft.to(dtype))
    bins = frame_length // 2 + 1
    return torch.complex(ri[..., :bins], ri[..., bins:])


def istft(spec: torch.Tensor, frame_length: int = 256, frame_shift: int = 128,
          window: str = "hann", center: bool = True,
          length: Optional[int] = None, dtype=torch.float32) -> torch.Tensor:
    """Batched iSTFT with window-square normalisation (librosa semantics).

    complex (..., T, F) -> (..., length); length defaults to (T-1)*hop for
    center=True (librosa's trimmed output). The spectrum's halves, the
    inverse DFT table and the window are in `dtype`, the inverse DFT
    accumulated in f32 and the overlap-add in f32; the window-square sum
    runs in `dtype`, as in JAX.
    """
    t = spec.shape[-2]
    tab = dsp_tables(frame_length, window, spec.device)
    win = tab.win.to(dtype)
    ri = torch.cat([spec.real, spec.imag], dim=-1).to(dtype)
    ola = overlap_add(_f32_product(ri, tab.idft.to(dtype)) * win,
                      frame_shift)
    wsum = overlap_add((win ** 2).expand(t, frame_length), frame_shift)
    ola = torch.where(wsum > 1e-10, ola / torch.clamp(wsum, min=1e-10), ola)
    return _trim(ola, t, frame_length, frame_shift, center, length)


def masked_resynthesis(re: torch.Tensor, im: torch.Tensor,
                       masks: torch.Tensor, cfg,
                       length: Optional[int] = None) -> torch.Tensor:
    """Waveforms of K masked channels: istft(mask (.) X) per channel.

    The reference's phase reapplication mask . |X| . e^{j angle X} -> istft
    with the magnitude division cancelled. re/im (B, T, F) are the mixture
    spectrum halves, masks (B, K, T, F) -> (B, K, length). Under
    cfg.use_pallas_stft the mask apply + iDFT + window + overlap-add run in
    the masked-iSTFT kernel (ops/stft_kernels.py), whose backward
    recomputes through this plain iSTFT, as `_fused_mr_bwd` does in JAX.
    """
    if cfg.use_pallas_stft:
        return _MaskedResynthesis.apply(re, im, masks, cfg, length)
    return _plain_masked_resynthesis(re, im, masks, cfg, length)


def _plain_masked_resynthesis(re, im, masks, cfg, length):
    spec = torch.complex(re, im)[:, None]
    return istft(masks.float() * spec, cfg.frame_length, cfg.frame_shift,
                 window=cfg.window, center=cfg.center, length=length)


class _MaskedResynthesis(torch.autograd.Function):
    """The masked-iSTFT kernel forward; a backward that recomputes through
    the algebraically identical plain iSTFT (one extra forward: the kernel
    has no backward of its own, in JAX either)."""

    @staticmethod
    def forward(ctx, re, im, masks, cfg, length):
        from dl4ss_tpu_torch.ops.stft_kernels import masked_istft
        ctx.save_for_backward(re, im, masks)
        ctx.args = (cfg, length)
        return masked_istft(re, im, masks, cfg.frame_length, cfg.frame_shift,
                            window=cfg.window, center=cfg.center,
                            length=length)

    @staticmethod
    def backward(ctx, grad):
        saved = [t.detach().requires_grad_(need)
                 for t, need in zip(ctx.saved_tensors,
                                    ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = _plain_masked_resynthesis(*saved, *ctx.args)
        wanted = [t for t in saved if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t.requires_grad else None for t in saved),
                None, None)


def magnitude_and_phase(spec: torch.Tensor, eps: float = 1e-8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a complex spectrogram into |X| and the unit phasor X/|X|."""
    mag = spec.abs()
    return mag, spec / torch.clamp(mag, min=eps)


def spectral_feature(wav: torch.Tensor, frame_length: int = 256,
                     frame_shift: int = 128, window: str = "hann",
                     log_spectral: bool = False, log_window: str = "sine",
                     center: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav -> (feature, complex spectrogram).

    Linear path: |STFT| with the analysis window. Log path: log(|STFT|+eps)
    of a sine-window STFT (the reference's IS_LOG_SPECTRAL features).
    """
    spec = stft(wav, frame_length, frame_shift, window=window, center=center)
    if log_spectral:
        lspec = stft(wav, frame_length, frame_shift, window=log_window,
                     center=center)
        feat = torch.log(lspec.abs() + float(np.spacing(np.float32(1.0))))
    else:
        feat = spec.abs()
    return feat, spec


# ---- Config-aware conveniences: cfg.window / cfg.center govern the DSP ----


def stft_cfg(wav: torch.Tensor, cfg) -> torch.Tensor:
    return stft(wav, cfg.frame_length, cfg.frame_shift, window=cfg.window,
                center=cfg.center)


def istft_cfg(spec: torch.Tensor, cfg, length: Optional[int] = None
              ) -> torch.Tensor:
    return istft(spec, cfg.frame_length, cfg.frame_shift, window=cfg.window,
                 center=cfg.center, length=length)


def spectral_feature_cfg(wav: torch.Tensor, cfg
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    return spectral_feature(wav, cfg.frame_length, cfg.frame_shift,
                            window=cfg.window, log_spectral=cfg.log_spectral,
                            center=cfg.center)
