"""Shared layer helpers (the port of `dl4ss_tpu/models/common.py`).

`Linear` stores its weight `(in, out)` as `w` — the JAX layout, the
transpose of `nn.Linear` — so JAX parameter pytrees load leaf for leaf.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from dl4ss_tpu_torch.device import resolve_device


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        scale = 1.0 / np.sqrt(in_dim)

        def uniform(*shape):
            w = torch.empty(shape, dtype=torch.float32)
            w.uniform_(-scale, scale, generator=generator)
            return nn.Parameter(w.to(device=device, dtype=dtype))

        self.w = uniform(in_dim, out_dim)
        self.b = uniform(out_dim) if bias else None


def linear_init(in_dim: int, out_dim: int, bias: bool = True,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None) -> Linear:
    """torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""
    return Linear(in_dim, out_dim, bias, generator, dtype, device)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b), accumulated in f32 and returned in x's dtype."""
    y = torch.matmul(x.float(), p.w.float()).to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y
