"""Long-signal cross-correlation and convolution by overlap-save FFTs (the
port of `dl4ss_tpu/ops/xcorr.py`).

BSS-Eval needs every lag correlation c_ab[l] = sum_u a[u] b[u+l] between
40,000-sample signals for |l| < 512, and FIR filters of 512 taps applied
to them. The JAX package writes the chunk DFTs as matmuls against DFT
matrices because the TPU has no `jnp.fft`; here the same overlap-save
chunking runs on `torch.fft.rfft` / `irfft` (cuFFT on the card). Not a
Pallas kernel in JAX, so no hand-written kernel here. Every function takes
leading batch dimensions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def xcorr(a_sigs: torch.Tensor, b_sigs: torch.Tensor, lo: int, hi: int,
          fft_size: int = 0) -> torch.Tensor:
    """c[..., b, a, l] = sum_u a_sigs[..., a, u] * b_sigs[..., b, u + l] for
    l in [lo, hi]; indices outside either signal read 0.

    a_sigs (..., Ka, Na), b_sigs (..., Kb, Nb) -> (..., Kb, Ka, hi - lo + 1)
    in the inputs' dtype. Chunks of `fft_size` points (default the
    JAX package's: max(1024, the power of two >= 2 * lags))."""
    na, nb = a_sigs.shape[-1], b_sigs.shape[-1]
    nlag = hi - lo + 1
    p = fft_size or max(1024, _next_pow2(2 * nlag))
    chunk = p - nlag + 1                     # a-chunk length, no wraparound
    m = -(-na // chunk)
    # a in m chunks of `chunk` samples, each zero-padded to p by the FFT
    a = F.pad(a_sigs, (0, m * chunk - na)).unflatten(-1, (m, chunk))
    # chunk i of b covers b[i * chunk + lo : i * chunk + lo + p)
    left = max(-lo, 0)
    start = max(lo, 0)
    right = max(start + m * chunk + p - (left + nb), 0)
    b = F.pad(b_sigs, (left, right))[..., start:start + (m - 1) * chunk + p]
    b = b.unfold(-1, p, chunk)                            # (..., Kb, m, p)
    fa = torch.fft.rfft(a, n=p)                           # (..., Ka, m, f)
    fb = torch.fft.rfft(b, n=p)                           # (..., Kb, m, f)
    z = torch.einsum("...amf,...bmf->...baf", fa.conj(), fb)
    return torch.fft.irfft(z, n=p)[..., :nlag]


def _overlap_add(y: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., m, w) chunk outputs with hop <= w <= 2 * hop, chunk i placed at
    i * hop and summed -> (..., (m + 1) * hop)."""
    head = y[..., :hop].flatten(-2)
    tail = F.pad(y[..., hop:], (0, 2 * hop - y.shape[-1])).flatten(-2)
    return F.pad(head, (0, hop)) + F.pad(tail, (hop, 0))


def ola_conv(sigs: torch.Tensor, kernels: torch.Tensor,
             sum_channels: bool = True, fft_size: int = 0) -> torch.Tensor:
    """Linear convolution y = sigs * kernels by overlap-save FFTs.

    sigs (..., Ka, N), kernels (..., J, Ka, F) -> (..., J, N + F - 1), summed
    over Ka, when sum_channels, else (..., J, Ka, N + F - 1)."""
    n, f = sigs.shape[-1], kernels.shape[-1]
    if kernels.shape[-2] != sigs.shape[-2]:
        raise ValueError(f"kernels {tuple(kernels.shape)} do not match the "
                         f"channels of sigs {tuple(sigs.shape)}")
    p = fft_size or max(1024, _next_pow2(2 * f))
    chunk = p - f + 1
    m = -(-n // chunk)
    s = F.pad(sigs, (0, m * chunk - n)).unflatten(-1, (m, chunk))
    fs = torch.fft.rfft(s, n=p)                           # (..., Ka, m, b)
    fk = torch.fft.rfft(kernels, n=p)                     # (..., J, Ka, b)
    if sum_channels:
        yf = torch.einsum("...amf,...jaf->...jmf", fs, fk)
    else:
        yf = fs.unsqueeze(-4) * fk.unsqueeze(-2)          # (..., J, Ka, m, b)
    # each chunk's output is valid on [0, chunk + F - 1)
    y = torch.fft.irfft(yf, n=p)[..., :chunk + f - 1]
    return _overlap_add(y, chunk)[..., :n + f - 1]
