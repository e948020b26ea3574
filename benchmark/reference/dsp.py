"""STFT and iSTFT as librosa defines them: centered frames with reflect
padding, a periodic Hann window, and the inverse's window-square
normalisation. A 40,000-sample utterance at frame 256, hop 128 gives 313
frames of 129 bins, and the inverse returns (T - 1) * hop samples."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def hann(length: int, device) -> torch.Tensor:
    n = torch.arange(length, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / length)).to(
        torch.float32).to(device)


def stft(x: torch.Tensor, frame_length: int, frame_shift: int
         ) -> torch.Tensor:
    """(..., N) float32 -> complex (..., T, F)."""
    lead, n = x.shape[:-1], x.shape[-1]
    pad = frame_length // 2
    xp = F.pad(x.reshape(-1, 1, n), (pad, pad), mode="reflect")
    frames = xp.reshape(*lead, n + 2 * pad).unfold(-1, frame_length,
                                                   frame_shift)
    return torch.fft.rfft(frames * hann(frame_length, x.device), dim=-1)


def _overlap_add(frames: torch.Tensor, frame_shift: int) -> torch.Tensor:
    """(M, T, L) -> (M, (T - 1) * hop + L)."""
    m, t, length = frames.shape
    out_len = (t - 1) * frame_shift + length
    y = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
               kernel_size=(1, length), stride=(1, frame_shift))
    return y.reshape(m, out_len)


def istft(spec: torch.Tensor, frame_length: int, frame_shift: int,
          length: Optional[int] = None) -> torch.Tensor:
    """complex (..., T, F) -> (..., length), length (T - 1) * hop by
    default."""
    lead, t = spec.shape[:-2], spec.shape[-2]
    win = hann(frame_length, spec.device)
    frames = torch.fft.irfft(spec.reshape(-1, t, spec.shape[-1]),
                             n=frame_length, dim=-1) * win
    ola = _overlap_add(frames, frame_shift)
    wsum = _overlap_add((win ** 2).expand(1, t, frame_length), frame_shift)
    ola = torch.where(wsum > 1e-10, ola / wsum.clamp(min=1e-10), ola)
    pad = frame_length // 2
    out = ola[:, pad:ola.shape[-1] - pad]
    if length is not None:
        out = out[:, :length] if length <= out.shape[-1] else F.pad(
            out, (0, length - out.shape[-1]))
    return out.reshape(*lead, out.shape[-1])
