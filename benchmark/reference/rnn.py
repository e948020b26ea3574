"""Bidirectional GRU and LSTM stacks as loops over time.

GRU (torch's form): r = s(x Wr + br + h Ur + cr), z = s(x Wz + bz + h Uz
+ cz), n = tanh(x Wn + bn + r * (h Un + cn)), h' = (1 - z) n + z h.
LSTM: i, f, g, o = split(x W + b + h U + c); c' = s(f) c + s(i) tanh(g);
h' = s(o) tanh(c'). The backward direction reads the sequence reversed and
its outputs are put back in time order; a layer's output is [fwd | bwd].
"""

from __future__ import annotations

from typing import Dict

import torch


def _step_gru(xp, a, h, hidden):
    r = torch.sigmoid(xp[..., :hidden] + a[..., :hidden])
    z = torch.sigmoid(xp[..., hidden:2 * hidden] + a[..., hidden:2 * hidden])
    n = torch.tanh(xp[..., 2 * hidden:] + r * a[..., 2 * hidden:])
    return (1.0 - z) * n + z * h, None


def _step_lstm(xp, a, state, hidden):
    h, c = state
    g = xp + a
    i, f, gg, o = g.split(hidden, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def layer(params: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
          cell: str) -> torch.Tensor:
    """x (B, T, D) -> (B, T, 2H); both directions ride one batched
    product per step."""
    cells = [f"{prefix}.fwd", f"{prefix}.bwd"]
    hidden = params[f"{cells[0]}.wh"].shape[0]
    inputs = torch.stack([x, torch.flip(x, (1,))])             # (2, B, T, D)
    wx = torch.stack([params[f"{c}.wx"] for c in cells])        # (2, D, GH)
    bx = torch.stack([params[f"{c}.bx"] for c in cells])
    wh = torch.stack([params[f"{c}.wh"] for c in cells])        # (2, H, GH)
    bh = torch.stack([params[f"{c}.bh"] for c in cells])
    b, t = x.shape[0], x.shape[1]
    xp = torch.matmul(inputs, wx[:, None]) + bx[:, None, None]  # (2,B,T,GH)
    h = x.new_zeros((2, b, hidden))
    c = x.new_zeros((2, b, hidden))
    outs = []
    for s in range(t):
        a = torch.baddbmm(bh[:, None], h, wh)                   # (2, B, GH)
        if cell == "gru":
            h, _ = _step_gru(xp[:, :, s], a, h, hidden)
        else:
            h, c = _step_lstm(xp[:, :, s], a, (h, c), hidden)
        outs.append(h)
    hs = torch.stack(outs, dim=2)                               # (2,B,T,H)
    return torch.cat([hs[0], torch.flip(hs[1], (1,))], dim=-1)


def stack(params: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
          cell: str, layers: int) -> torch.Tensor:
    for i in range(layers):
        x = layer(params, f"{prefix}.{i}", x, cell)
    return x
