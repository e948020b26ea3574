"""LSTM / GRU recurrences (the port of `dl4ss_tpu/ops/rnn.py`).

Parameters keep the JAX layout and names — per cell `wx (D, G*H)`,
`wh (H, G*H)`, `bx`, `bh (G*H,)` — with torch's gate order (i,f,g,o for
LSTM; r,z,n for GRU, the candidate using r * (h@U_n + b_n)). A layer is a
module with a `fwd` cell and, when bidirectional, a `bwd` cell, so a
stack's parameters are named `<stack>.<layer>.fwd.wx` like the JAX pytree
leaves.

Two routes per layer, as in JAX, for either direction count D (1 or 2):
  * `_run_layer`: the plain loop, the directions in one batched step (for
    GRU, K2's plain version `gru_scan_plain`; for LSTM the JAX scan route's
    numerics: c rounded to the compute dtype at every step);
  * `_run_layer_kernel` (use_pallas): the input projection as one torch
    matmul per direction, the direction flip outside, and the whole
    recurrence in K2 (GRU) or K7 (LSTM, c carried in f32), whose backwards
    are K5 and K8 (ops/rnn_kernels.py). JAX runs a one-direction layer as
    a `lax.scan` whatever `use_pallas` says; the port sends it to the same
    kernels with D = 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.ops.rnn_kernels import (gru_scan, gru_scan_plain,
                                             lstm_scan)

_GATES = {"lstm": 4, "gru": 3}


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


def lstm_init(input_size: int, hidden_size: int,
              generator: Optional[torch.Generator] = None,
              dtype=torch.float32, device=None) -> Cell:
    """One LSTM cell (JAX `lstm_init`) on `device`: `cuda` unless the
    caller passes device='cpu'."""
    return Cell(input_size, hidden_size, _GATES["lstm"], generator, dtype,
                device)


def gru_init(input_size: int, hidden_size: int,
             generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None) -> Cell:
    """One GRU cell (JAX `gru_init`) on `device`."""
    return Cell(input_size, hidden_size, _GATES["gru"], generator, dtype,
                device)


class Layer(nn.Module):
    """One layer: a `fwd` cell and, when bidirectional, a `bwd` cell that
    reads the sequence backwards."""

    def __init__(self, cell: str, input_size: int, hidden_size: int,
                 generator=None, dtype=torch.float32, device=None,
                 bidirectional: bool = True):
        super().__init__()
        self.fwd = Cell(input_size, hidden_size, _GATES[cell], generator,
                        dtype, device)
        if bidirectional:
            self.bwd = Cell(input_size, hidden_size, _GATES[cell], generator,
                            dtype, device)


def rnn_init(cell: str, input_size: int, hidden_size: int, num_layers: int,
             generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None,
             bidirectional: bool = True) -> nn.ModuleList:
    """A multi-layer stack (the JAX `rnn_init` layout) on `device`: `cuda`
    unless the caller passes device='cpu'. Bidirectional layers hold `fwd`
    and `bwd` and feed 2H features on; one-direction layers hold `fwd`
    alone and feed H."""
    layers = nn.ModuleList()
    d = input_size
    for _ in range(num_layers):
        layers.append(Layer(cell, d, hidden_size, generator, dtype, device,
                            bidirectional))
        d = (2 if bidirectional else 1) * hidden_size
    return layers


def _cells(layer: nn.Module) -> tuple:
    """(fwd,) or (fwd, bwd): a layer's directions in kernel order."""
    return (layer.fwd, layer.bwd) if hasattr(layer, "bwd") else (layer.fwd,)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and f32 result (preferred_element_type)."""
    return torch.matmul(a.float(), b.float())


def _inputs(x: torch.Tensor, directions: int) -> list:
    """Each direction's input: x, then x reversed in time."""
    return [x, torch.flip(x, (1,))][:directions]


def _gru_operands(cells: Sequence[Cell], x: torch.Tensor, dtype, wdtype):
    """The `gru_scan` operands of a GRU layer of D = len(cells) directions:
    xp (T, D, B, 3H) = x @ Wx + bx + bh_rz in `dtype`, the time-reversed
    direction flipped; wh (D, H, 3H) in `wdtype`; bh_n (D, 1, H) f32. The
    candidate's bh_n stays inside r * (h @ U_n + bh_n) (torch GRU
    layout)."""
    hidden = cells[0].wh.shape[0]

    def proj(xx, p):
        bh = p.bh.float().clone()
        bh[2 * hidden:] = 0.0
        return (_mm(xx, p.wx.to(wdtype)) + p.bx.float() + bh).to(dtype)

    xp = torch.stack([proj(xx, p) for p, xx in
                      zip(cells, _inputs(x, len(cells)))], dim=2)
    xp = xp.permute(1, 2, 0, 3).contiguous()                # (T, D, B, 3H)
    wh = torch.stack([p.wh for p in cells]).to(wdtype).contiguous()
    bh_n = torch.stack([p.bh[None, 2 * hidden:]
                        for p in cells]).float().contiguous()
    return xp, wh, bh_n


def _lstm_operands(cells: Sequence[Cell], x: torch.Tensor, dtype):
    """The `lstm_scan` operands of an LSTM layer of D = len(cells)
    directions: xp (T, D, B, 4H) = x @ Wx + bx + bh in `dtype` (every bias
    folded in), the time-reversed direction flipped; wh (D, H, 4H) in
    `dtype`."""
    def proj(xx, p):
        return (_mm(xx, p.wx.to(dtype)) + p.bx.float()
                + p.bh.float()).to(dtype)

    xp = torch.stack([proj(xx, p) for p, xx in
                      zip(cells, _inputs(x, len(cells)))], dim=2)
    xp = xp.permute(1, 2, 0, 3).contiguous()                # (T, D, B, 4H)
    wh = torch.stack([p.wh for p in cells]).to(dtype).contiguous()
    return xp, wh


def _unflip(hs: torch.Tensor, dtype) -> torch.Tensor:
    """hs (T, D, B, H) -> (B, T, D*H), the reverse direction unflipped."""
    outs = [hs[:, 0].transpose(0, 1)]
    if hs.shape[1] == 2:
        outs.append(torch.flip(hs[:, 1].transpose(0, 1), (1,)))
    return torch.cat(outs, dim=-1).to(dtype)


def _run_layer_kernel(cells: Sequence[Cell], x: torch.Tensor,
                      cell: str) -> torch.Tensor:
    """A layer on K2 (GRU) or K7 (LSTM): the input projections as one
    matmul per direction, the time-reversed direction flipped here, and
    the whole recurrence of its D directions in one `gru_scan` or
    `lstm_scan` call."""
    # bf16 keeps bf16 operands (f32 accumulation); anything else runs in f32
    kdtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    if cell == "gru":
        hs = gru_scan(*_gru_operands(cells, x, kdtype, kdtype))
    elif cell == "lstm":
        hs = lstm_scan(*_lstm_operands(cells, x, kdtype))
    else:
        raise ValueError(f"unknown cell {cell!r}")
    return _unflip(hs, x.dtype)


def _run_layer(cells: Sequence[Cell], x: torch.Tensor, cell: str
               ) -> torch.Tensor:
    """A layer as one loop: the time-reversed sequence rides a leading
    direction axis, so each step is one batched (D, B, H) x (D, H, G*H)
    product with each direction's own U. GRU runs K2's plain version on
    f32 weights (the JAX scan route's numerics)."""
    if cell == "gru":
        return _unflip(gru_scan_plain(*_gru_operands(
            cells, x, x.dtype, torch.float32)), x.dtype)
    if cell != "lstm":
        raise ValueError(f"unknown cell {cell!r}")
    b, t, _ = x.shape
    hidden = cells[0].wh.shape[0]
    dtype = x.dtype

    def proj(p, xx):
        return (_mm(xx, p.wx) + p.bx.float()).to(dtype)

    xp = torch.stack([proj(p, xx) for p, xx in
                      zip(cells, _inputs(x, len(cells)))])
    xp = xp.transpose(1, 2)                                  # (D, T, B, 4H)
    wh = torch.stack([p.wh for p in cells]).float()          # (D, H, 4H)
    bh = torch.stack([p.bh for p in cells]).float()[:, None, :]
    h = torch.zeros((len(cells), b, hidden), dtype=dtype, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for s in range(t):
        gates = xp[:, s] + torch.bmm(h.float(), wh) + bh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = (torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)).to(dtype)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
        hs.append(h)
    return _unflip(torch.stack(hs), dtype)                   # (T, D, B, H)


def bidirectional_rnn(layers: nn.ModuleList, x: torch.Tensor, cell: str,
                      use_pallas: bool = False, remat: bool = False
                      ) -> torch.Tensor:
    """Multi-layer (bi)RNN: (B, T, D) -> (B, T, 2H), or (B, T, H) for a
    stack of one-direction layers. `use_pallas` takes the kernel route
    (the config's use_pallas_rnn flag), for one direction as for two.
    `remat` (cfg.remat, JAX's `jax.checkpoint` per layer) keeps only each
    layer's input for the backward and runs the layer again there: on the
    kernel route the recompute relaunches K2 / K7 before K5 / K8."""
    run = _run_layer_kernel if use_pallas else _run_layer
    for layer in layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(run, _cells(layer), x, cell, use_reentrant=False)
        else:
            x = run(_cells(layer), x, cell)
    return x
