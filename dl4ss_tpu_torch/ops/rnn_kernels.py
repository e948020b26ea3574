"""K2, the BiGRU forward recurrence: CUDA kernel and plain version.

Ports `pallas_gru_scan`'s forward (dl4ss_tpu/ops/pallas_rnn.py). `gru_scan`
sends a CPU tensor to the plain PyTorch loop and a CUDA tensor to the
hand-written kernel (csrc/gru_fwd.cu); there is no fallback between them.
Unlike the TPU kernel, the hidden width needs no 128-lane padding.
"""

from __future__ import annotations

import torch

from dl4ss_tpu_torch.ops import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)


def gru_scan(xp: torch.Tensor, wh: torch.Tensor, bh_n: torch.Tensor
             ) -> torch.Tensor:
    """xp (T, D, B, 3H) input projections (+ r,z biases folded in), wh
    (D, H, 3H) recurrent weights in xp's dtype, bh_n (D, 1, H) f32
    candidate bias -> hs (T, D, B, H) in xp's dtype, with h0 = 0.

    f32 inputs compute in f32; bf16 inputs keep bf16 operands and carry
    with f32 accumulation, as the JAX kernel does."""
    if xp.is_cuda:
        return gru_scan_cuda(xp, wh, bh_n)
    return gru_scan_plain(xp, wh, bh_n)


def gru_scan_plain(xp: torch.Tensor, wh: torch.Tensor, bh_n: torch.Tensor
                   ) -> torch.Tensor:
    """K2's plain version: the same gate math as a loop over time."""
    t, d, b, g3 = xp.shape
    hidden = g3 // 3
    w = wh.float()
    h = torch.zeros((d, b, hidden), dtype=xp.dtype, device=xp.device)
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=xp.device)
    for s in range(t):
        a = torch.bmm(h.float(), w)                       # (D, B, 3H)
        x = xp[s].float()
        rz = torch.sigmoid(x[..., :2 * hidden] + a[..., :2 * hidden])
        r, z = rz[..., :hidden], rz[..., hidden:]
        n = torch.tanh(x[..., 2 * hidden:] + r * (a[..., 2 * hidden:] + bh_n))
        h = ((1.0 - z) * n + z * h.float()).to(xp.dtype)
        hs[s] = h
    return hs


def gru_scan_cuda(xp: torch.Tensor, wh: torch.Tensor, bh_n: torch.Tensor
                  ) -> torch.Tensor:
    """K2 on the card: csrc/gru_fwd.cu, one ctypes call per layer that
    launches one step kernel per time step on the current stream."""
    t, d, b, g3 = xp.shape
    if g3 % 3:
        raise ValueError(f"xp's last axis must be 3H, got {g3}")
    hidden = g3 // 3
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, g3))
    cuda_lib.check(bh_n, "bh_n", (torch.float32,), (d, 1, hidden))
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=xp.device)
    cuda_lib.launch("gru_fwd", xp.device, xp, wh, bh_n, hs, t, d, b, hidden,
                    int(xp.dtype == torch.bfloat16))
    return hs
