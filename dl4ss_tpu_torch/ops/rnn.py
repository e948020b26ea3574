"""LSTM / GRU recurrences (the port of `dl4ss_tpu/ops/rnn.py`).

Parameters keep the JAX layout and names — per cell `wx (D, G*H)`,
`wh (H, G*H)`, `bx`, `bh (G*H,)` — with torch's gate order (i,f,g,o for
LSTM; r,z,n for GRU, the candidate using r * (h@U_n + b_n)). A
bidirectional layer is a module with `fwd` and `bwd` cells, so a stack's
parameters are named `<stack>.<layer>.fwd.wx` like the JAX pytree leaves.

Two routes per bidirectional layer, as in JAX:
  * `_run_layer_bidir`: the plain loop, both directions in one batched step
    (for GRU, K2's plain version `gru_scan_plain`);
  * `_run_layer_bidir_kernel` (use_pallas): the input projection as one
    torch matmul, the direction flip outside, and the whole recurrence in
    K2 (ops/rnn_kernels.py) — GRU only until the LSTM kernel K7 is ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.ops.rnn_kernels import gru_scan, gru_scan_plain


class Cell(nn.Module):
    """One direction of one recurrent layer, in the JAX layout."""

    def __init__(self, input_size: int, hidden_size: int, gates: int,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        scale = 1.0 / np.sqrt(hidden_size)
        g = gates * hidden_size

        def uniform(*shape):
            # torch-style init U(-1/sqrt(H), 1/sqrt(H)); drawn on the CPU so
            # a seed gives the same weights on every device
            w = torch.empty(shape, dtype=torch.float32)
            w.uniform_(-scale, scale, generator=generator)
            return nn.Parameter(w.to(device=device, dtype=dtype))

        self.wx = uniform(input_size, g)
        self.wh = uniform(hidden_size, g)
        self.bx = uniform(g)
        self.bh = uniform(g)


class BiLayer(nn.Module):
    def __init__(self, cell: str, input_size: int, hidden_size: int,
                 generator=None, dtype=torch.float32, device=None):
        super().__init__()
        gates = {"lstm": 4, "gru": 3}[cell]
        self.fwd = Cell(input_size, hidden_size, gates, generator, dtype,
                        device)
        self.bwd = Cell(input_size, hidden_size, gates, generator, dtype,
                        device)


def rnn_init(cell: str, input_size: int, hidden_size: int, num_layers: int,
             generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None) -> nn.ModuleList:
    """A multi-layer bidirectional stack (the JAX `rnn_init` layout) on
    `device`: `cuda` unless the caller passes device='cpu'."""
    layers = nn.ModuleList()
    d = input_size
    for _ in range(num_layers):
        layers.append(BiLayer(cell, d, hidden_size, generator, dtype, device))
        d = 2 * hidden_size
    return layers


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and f32 result (preferred_element_type)."""
    return torch.matmul(a.float(), b.float())


def _gru_operands(fwd: Cell, bwd: Cell, x: torch.Tensor, dtype, wdtype):
    """The `gru_scan` operands of a bidirectional GRU layer: xp (T, 2, B, 3H)
    = x @ Wx + bx + bh_rz in `dtype`, the time-reversed direction flipped;
    wh (2, H, 3H) in `wdtype`; bh_n (2, 1, H) f32. The candidate's bh_n
    stays inside r * (h @ U_n + bh_n) (torch GRU layout)."""
    hidden = fwd.wh.shape[0]

    def proj(xx, p):
        bh = p.bh.float().clone()
        bh[2 * hidden:] = 0.0
        return (_mm(xx, p.wx.to(wdtype)) + p.bx.float() + bh).to(dtype)

    xp = torch.stack([proj(x, fwd), proj(torch.flip(x, (1,)), bwd)], dim=2)
    xp = xp.permute(1, 2, 0, 3).contiguous()                # (T, 2, B, 3H)
    wh = torch.stack([fwd.wh, bwd.wh]).to(wdtype).contiguous()
    bh_n = torch.stack([fwd.bh[None, 2 * hidden:],
                        bwd.bh[None, 2 * hidden:]]).float().contiguous()
    return xp, wh, bh_n


def _unflip(hs: torch.Tensor, dtype) -> torch.Tensor:
    """hs (T, 2, B, H) -> (B, T, 2H), the reverse direction unflipped."""
    fwd_out = hs[:, 0].transpose(0, 1)
    bwd_out = torch.flip(hs[:, 1].transpose(0, 1), (1,))
    return torch.cat([fwd_out, bwd_out], dim=-1).to(dtype)


def _run_layer_bidir_kernel(fwd: Cell, bwd: Cell, x: torch.Tensor,
                            cell: str) -> torch.Tensor:
    """Bidirectional GRU layer on K2: the input projections as one matmul
    per direction, the time-reversed direction flipped here, and the whole
    recurrence of both directions in one `gru_scan` call."""
    if cell == "lstm":
        if x.is_cuda:
            raise NotImplementedError(
                "the BiLSTM kernel (K7, pallas_rnn.py::_lstm_fwd_kernel) is "
                "not ported yet; run LSTM configs with use_pallas_rnn=False")
        return _run_layer_bidir(fwd, bwd, x, cell)
    if cell != "gru":
        raise ValueError(f"unknown cell {cell!r}")
    # bf16 keeps bf16 operands (f32 accumulation); anything else runs in f32
    kdtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    return _unflip(gru_scan(*_gru_operands(fwd, bwd, x, kdtype, kdtype)),
                   x.dtype)


def _run_layer_bidir(fwd: Cell, bwd: Cell, x: torch.Tensor, cell: str
                     ) -> torch.Tensor:
    """Bidirectional layer as one loop: the time-reversed sequence rides a
    leading direction axis, so each step is one batched (2, B, H) x
    (2, H, G*H) product with each direction's own U. GRU runs K2's plain
    version on f32 weights (the JAX scan route's numerics)."""
    if cell == "gru":
        return _unflip(gru_scan_plain(*_gru_operands(
            fwd, bwd, x, x.dtype, torch.float32)), x.dtype)
    if cell != "lstm":
        raise ValueError(f"unknown cell {cell!r}")
    b, t, _ = x.shape
    hidden = fwd.wh.shape[0]
    dtype = x.dtype

    def proj(p, xx):
        return (_mm(xx, p.wx) + p.bx.float()).to(dtype)

    xp = torch.stack([proj(fwd, x), proj(bwd, torch.flip(x, (1,)))])
    xp = xp.transpose(1, 2)                                  # (2, T, B, 4H)
    wh = torch.stack([fwd.wh, bwd.wh]).float()               # (2, H, 4H)
    bh = torch.stack([fwd.bh, bwd.bh]).float()[:, None, :]   # (2, 1, 4H)
    h = torch.zeros((2, b, hidden), dtype=dtype, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for s in range(t):
        gates = xp[:, s] + torch.bmm(h.float(), wh) + bh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = (torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)).to(dtype)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
        hs.append(h)
    return _unflip(torch.stack(hs), dtype)                   # (T, 2, B, H)


def bidirectional_rnn(layers: nn.ModuleList, x: torch.Tensor, cell: str,
                      use_pallas: bool = False) -> torch.Tensor:
    """Multi-layer BiRNN: (B, T, D) -> (B, T, 2H). `use_pallas` takes the
    kernel route (the config's use_pallas_rnn flag)."""
    run = _run_layer_bidir_kernel if use_pallas else _run_layer_bidir
    for layer in layers:
        x = run(layer.fwd, layer.bwd, x, cell)
    return x
