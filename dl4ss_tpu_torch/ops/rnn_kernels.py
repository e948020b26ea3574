"""The recurrent kernels: K2 and K5 (the BiGRU forward recurrence and its
backward), K7 and K8 (the BiLSTM's). CUDA kernels and plain versions.

Ports `pallas_gru_scan` and `pallas_lstm_scan` (dl4ss_tpu/ops/pallas_rnn.py)
with their custom VJPs. `gru_scan` and `lstm_scan` are
`torch.autograd.Function`s: the forward sends a CPU tensor to the plain
PyTorch loop and a CUDA tensor to the hand-written kernel (csrc/gru_fwd.cu,
csrc/lstm_fwd.cu), the backward likewise to the plain reverse loop or to
csrc/gru_bwd.cu, csrc/lstm_bwd.cu; there is no fallback between them.
Unlike the TPU kernels, the hidden width needs no 128-lane padding.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dl4ss_tpu_torch.ops import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)


class _GruScan(torch.autograd.Function):
    """pallas_gru_scan with its VJP: saves (xp, wh, bh_n, hs) as
    `_gru_fwd_vjp` does and rebuilds h_prev in the backward."""

    @staticmethod
    def forward(ctx, xp, wh, bh_n):
        hs = gru_scan_cuda(xp, wh, bh_n) if xp.is_cuda else \
            gru_scan_plain(xp, wh, bh_n)
        ctx.save_for_backward(xp, wh, bh_n, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xp, wh, bh_n, hs = ctx.saved_tensors
        hprev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        bwd = gru_scan_bwd_cuda if xp.is_cuda else gru_scan_bwd_plain
        return bwd(xp, wh, bh_n, hprev, dhs.contiguous())


def gru_scan(xp: torch.Tensor, wh: torch.Tensor, bh_n: torch.Tensor
             ) -> torch.Tensor:
    """xp (T, D, B, 3H) input projections (+ r,z biases folded in), wh
    (D, H, 3H) recurrent weights in xp's dtype, bh_n (D, 1, H) f32
    candidate bias -> hs (T, D, B, H) in xp's dtype, with h0 = 0.

    f32 inputs compute in f32; bf16 inputs keep bf16 operands and carry
    with f32 accumulation, as the JAX kernel does. Differentiable: the
    backward is K5 on the card."""
    return _GruScan.apply(xp, wh, bh_n)


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


def gru_scan_bwd_plain(xp, wh, bh_n, hprev, dhs
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's plain version: `_gru_bwd_kernel`'s math as a loop run in
    reverse. hprev (T, D, B, H) is hs one step late (zero at t = 0); dhs
    (T, D, B, H) in xp's dtype. Returns dxp (T, D, B, 3H) in xp's dtype, dU
    (D, H, 3H) accumulated in f32 and cast to wh's dtype, and db_n
    (D, 1, H). In bf16, da_w is rounded to bf16 before both products."""
    t, d, b, g3 = xp.shape
    hidden = g3 // 3
    w = wh.float()
    dxp = torch.empty_like(xp)
    du = torch.zeros((d, hidden, g3), dtype=torch.float32, device=xp.device)
    dbn = torch.zeros((d, 1, hidden), dtype=torch.float32, device=xp.device)
    carry = torch.zeros((d, b, hidden), dtype=torch.float32, device=xp.device)
    for s in reversed(range(t)):
        hp = hprev[s].float()
        a = torch.bmm(hp, w)                              # gate recompute
        x = xp[s].float()
        rz = torch.sigmoid(x[..., :2 * hidden] + a[..., :2 * hidden])
        r, z = rz[..., :hidden], rz[..., hidden:]
        hn = a[..., 2 * hidden:] + bh_n
        n = torch.tanh(x[..., 2 * hidden:] + r * hn)
        dh = carry + dhs[s].float()
        dn = dh * (1.0 - z)
        dz = dh * (hp - n)
        da_n = dn * (1.0 - n * n)
        dr = da_n * hn
        dhn = da_n * r
        da_z = dz * z * (1.0 - z)
        da_r = dr * r * (1.0 - r)
        # xp sees (da_r, da_z, da_n); the recurrent product (da_r, da_z, dhn)
        dxp[s] = torch.cat([da_r, da_z, da_n], dim=-1).to(xp.dtype)
        da_w = torch.cat([da_r, da_z, dhn], dim=-1).to(dhs.dtype).float()
        carry = dh * z + torch.bmm(da_w, w.transpose(1, 2))
        du += torch.bmm(hp.transpose(1, 2), da_w)
        dbn += dhn.sum(dim=1, keepdim=True)
    return dxp, du.to(wh.dtype), dbn.to(bh_n.dtype)


def gru_scan_bwd_cuda(xp, wh, bh_n, hprev, dhs
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 on the card: csrc/gru_bwd.cu, one ctypes call per layer that
    transposes U, launches one step kernel per time step in reverse, then
    reduces dU and db_n. Same contract as `gru_scan_bwd_plain`."""
    t, d, b, g3 = xp.shape
    if g3 % 3:
        raise ValueError(f"xp's last axis must be 3H, got {g3}")
    hidden = g3 // 3
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, g3))
    cuda_lib.check(bh_n, "bh_n", (torch.float32,), (d, 1, hidden))
    cuda_lib.check(hprev, "hprev", (xp.dtype,), (t, d, b, hidden))
    cuda_lib.check(dhs, "dhs", (xp.dtype,), (t, d, b, hidden))
    dev = xp.device
    dxp = torch.empty_like(xp)
    du = torch.empty((d, hidden, g3), dtype=torch.float32, device=dev)
    dbn = torch.empty((d, 1, hidden), dtype=torch.float32, device=dev)
    wht = torch.empty((d, g3, hidden), dtype=xp.dtype, device=dev)
    daw = torch.empty_like(xp)
    dhz = torch.empty((d, b, hidden), dtype=torch.float32, device=dev)
    dhn = torch.empty((t, d, b, hidden), dtype=torch.float32, device=dev)
    cuda_lib.launch("gru_bwd", dev, xp, wh, bh_n, hprev, dhs, dxp, du, dbn,
                    wht, daw, dhz, dhn, t, d, b, hidden,
                    int(xp.dtype == torch.bfloat16))
    return dxp, du.to(wh.dtype), dbn


# ---------------------------------------------------------------------------
# LSTM: K7 (forward) and K8 (backward)
# ---------------------------------------------------------------------------


class _LstmScan(torch.autograd.Function):
    """pallas_lstm_scan with its VJP: saves (xp, wh, hs, cs) as
    `_lstm_fwd_vjp` does and rebuilds h_prev and c_prev in the backward."""

    @staticmethod
    def forward(ctx, xp, wh):
        hs, cs = lstm_scan_cuda(xp, wh) if xp.is_cuda else \
            lstm_scan_plain(xp, wh)
        ctx.save_for_backward(xp, wh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xp, wh, hs, cs = ctx.saved_tensors
        zeros = torch.zeros_like(hs[:1])
        hprev = torch.cat([zeros, hs[:-1]])
        cprev = torch.cat([zeros, cs[:-1]])
        bwd = lstm_scan_bwd_cuda if xp.is_cuda else lstm_scan_bwd_plain
        return bwd(xp, wh, hprev, cprev, cs, dhs.contiguous())


def lstm_scan(xp: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """xp (T, D, B, 4H) input projections with bx + bh folded in (gate order
    i, f, g, o), wh (D, H, 4H) recurrent weights in xp's dtype -> hs
    (T, D, B, H) in xp's dtype, with h0 = c0 = 0.

    f32 inputs compute in f32; bf16 inputs keep bf16 operands and a bf16 h
    with f32 accumulation, and the cell state is carried in f32 either way,
    as the JAX kernel does. Differentiable: the backward is K8 on the
    card."""
    return _LstmScan.apply(xp, wh)


def _lstm_gates(a: torch.Tensor, hidden: int):
    """Pre-activations (..., 4H) -> the gates i, f, g, o."""
    i, f = torch.sigmoid(a[..., :2 * hidden]).split(hidden, dim=-1)
    g = torch.tanh(a[..., 2 * hidden:3 * hidden])
    return i, f, g, torch.sigmoid(a[..., 3 * hidden:])


def lstm_scan_plain(xp: torch.Tensor, wh: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: `_lstm_fwd_kernel`'s math as a loop over time.
    Returns (hs, cs), both (T, D, B, H) in xp's dtype; h is carried in xp's
    dtype and c in f32 (only the stored cs is rounded)."""
    t, d, b, g4 = xp.shape
    hidden = g4 // 4
    w = wh.float()
    h = torch.zeros((d, b, hidden), dtype=xp.dtype, device=xp.device)
    c = torch.zeros((d, b, hidden), dtype=torch.float32, device=xp.device)
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(hs)
    for s in range(t):
        i, f, g, o = _lstm_gates(xp[s].float() + torch.bmm(h.float(), w),
                                 hidden)
        c = f * c + i * g
        h = (o * torch.tanh(c)).to(xp.dtype)
        hs[s] = h
        cs[s] = c.to(xp.dtype)
    return hs, cs


def _lstm_shape(xp: torch.Tensor):
    t, d, b, g4 = xp.shape
    if g4 % 4:
        raise ValueError(f"xp's last axis must be 4H, got {g4}")
    return t, d, b, g4 // 4


def lstm_scan_cuda(xp: torch.Tensor, wh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on the card: csrc/lstm_fwd.cu, one ctypes call per layer that
    launches one step kernel per time step on the current stream. Returns
    (hs, cs) as `lstm_scan_plain`."""
    t, d, b, hidden = _lstm_shape(xp)
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, 4 * hidden))
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(hs)
    carry = torch.empty((d, b, hidden), dtype=torch.float32, device=xp.device)
    cuda_lib.launch("lstm_fwd", xp.device, xp, wh, hs, cs, carry, t, d, b,
                    hidden, int(xp.dtype == torch.bfloat16))
    return hs, cs


def lstm_scan_bwd_plain(xp, wh, hprev, cprev, cs, dhs
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's plain version: `_lstm_bwd_kernel`'s math as a loop run in
    reverse. hprev and cprev (T, D, B, H) are hs and cs one step late (zero
    at t = 0); cs and dhs (T, D, B, H) in xp's dtype. Returns dxp
    (T, D, B, 4H) in xp's dtype and dU (D, H, 4H) accumulated in f32 and
    cast to wh's dtype. da is rounded to dhs's dtype before both the carry
    product and the dU sum."""
    t, d, b, g4 = xp.shape
    hidden = g4 // 4
    w = wh.float()
    dxp = torch.empty_like(xp)
    du = torch.zeros((d, hidden, g4), dtype=torch.float32, device=xp.device)
    dh_carry = torch.zeros((d, b, hidden), dtype=torch.float32,
                           device=xp.device)
    dc_carry = torch.zeros_like(dh_carry)
    for s in reversed(range(t)):
        hp = hprev[s].float()
        i, f, g, o = _lstm_gates(xp[s].float() + torch.bmm(hp, w), hidden)
        tc = torch.tanh(cs[s].float())
        dh = dh_carry + dhs[s].float()
        do = dh * tc
        dc = dc_carry + dh * o * (1.0 - tc * tc)
        di, dg, df = dc * g, dc * i, dc * cprev[s].float()
        dc_carry = dc * f
        da = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                        dg * (1.0 - g * g), do * o * (1.0 - o)],
                       dim=-1).to(dhs.dtype)
        dxp[s] = da.to(xp.dtype)
        da = da.float()
        dh_carry = torch.bmm(da, w.transpose(1, 2))
        du += torch.bmm(hp.transpose(1, 2), da)
    return dxp, du.to(wh.dtype)


def lstm_scan_bwd_cuda(xp, wh, hprev, cprev, cs, dhs
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 on the card: csrc/lstm_bwd.cu, one ctypes call per layer that
    transposes U, launches one step kernel per time step in reverse, then
    reduces dU. Same contract as `lstm_scan_bwd_plain`."""
    t, d, b, hidden = _lstm_shape(xp)
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, 4 * hidden))
    for name, arg in (("hprev", hprev), ("cprev", cprev), ("cs", cs),
                      ("dhs", dhs)):
        cuda_lib.check(arg, name, (xp.dtype,), (t, d, b, hidden))
    dev = xp.device
    dxp = torch.empty_like(xp)
    du = torch.empty((d, hidden, 4 * hidden), dtype=torch.float32, device=dev)
    wht = torch.empty((d, 4 * hidden, hidden), dtype=xp.dtype, device=dev)
    dc = torch.empty((d, b, hidden), dtype=torch.float32, device=dev)
    cuda_lib.launch("lstm_bwd", dev, xp, wh, hprev, cprev, cs, dhs, dxp, du,
                    wht, dc, t, d, b, hidden,
                    int(xp.dtype == torch.bfloat16))
    return dxp, du.to(wh.dtype)
