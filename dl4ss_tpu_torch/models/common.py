"""Shared layer helpers (the port of `dl4ss_tpu/models/common.py`).

`Linear` stores its weight `(in, out)` as `w` — the JAX layout, the
transpose of `nn.Linear` — and `Conv2d` its kernel as HWIO, so JAX
parameter pytrees load leaf for leaf.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
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


class Conv2d(nn.Module):
    """A 2-D convolution's kernel `w` (kh, kw, in, out) — JAX's HWIO, not
    torch's OIHW — and bias `b` (out,)."""

    def __init__(self, in_ch: int, out_ch: int, kh: int, kw: int,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        scale = 1.0 / np.sqrt(in_ch * kh * kw)

        def uniform(*shape):
            w = torch.empty(shape, dtype=torch.float32)
            w.uniform_(-scale, scale, generator=generator)
            return nn.Parameter(w.to(device=device, dtype=dtype))

        self.w = uniform(kh, kw, in_ch, out_ch)
        self.b = uniform(out_ch)


def conv_init(in_ch: int, out_ch: int, kh: int, kw: int,
              generator: Optional[torch.Generator] = None,
              dtype=torch.float32, device=None) -> Conv2d:
    """torch nn.Conv2d default: U(-s, s), s = 1/sqrt(in_ch*kh*kw)."""
    return Conv2d(in_ch, out_ch, kh, kw, generator, dtype, device)


def same_pads(size: int, kernel: int, stride: int):
    """XLA's SAME padding of one spatial axis: the output is ceil(size /
    stride), the total pad max((out - 1) * stride + kernel - size, 0), its
    lower half before the axis and the rest after it, so a stride > 1 can
    pad one more at the end than at the start."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_nchw(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                padding: str = "VALID") -> torch.Tensor:
    """x NCHW, w HWIO -> NCHW, no bias: `F.conv2d` with JAX's VALID or
    SAME padding (the latter through `F.pad` first where it is
    asymmetric)."""
    kh, kw = w.shape[0], w.shape[1]
    w = w.permute(3, 2, 0, 1)
    if padding == "VALID":
        return F.conv2d(x, w, stride=stride)
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    (top, bottom) = same_pads(x.shape[2], kh, stride[0])
    (left, right) = same_pads(x.shape[3], kw, stride[1])
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def conv2d(p: Conv2d, x: torch.Tensor, stride=(1, 1),
           padding: str = "VALID") -> torch.Tensor:
    """x NHWC -> NHWC, VALID or SAME padding (XLA's rule, `same_pads`),
    accumulated in f32 and returned in x's dtype: the layouts of JAX's
    conv2d, permuted around `F.conv2d` (cuDNN on the card, with TF32 off,
    see `resolve_device`)."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2).float(), p.w.float(), stride,
                    padding)
    return (y.permute(0, 2, 3, 1) + p.b.float()).to(x.dtype)
