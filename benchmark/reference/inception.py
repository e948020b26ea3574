"""Inception-v3's trunk (Szegedy et al., arXiv:1512.00567), NCHW, from
torchvision's Inception3 layer table: the stem, three A blocks (Mixed_5b
to 5d), the B grid reduction (6a), four C blocks with factorised 7x7
convolutions (6b to 6e), the D reduction (7a) and two E blocks (7b, 7c),
then the mean over the 8x8 grid: the 2048-d penultimate feature.

Every convolution is BasicConv2d in eval mode with its batch norm folded:
relu(conv(x, w) * scale + shift), `w` stored (kh, kw, in, out). The
average pools are 3x3, stride 1, padding 1, counting the padding
(F.avg_pool2d's default), the max pools 3x3 stride 2. The auxiliary head
and the 1000-way classifier hold parameters but take no part in the
feature. Frames come in as uint8 pixel values (N, H, W, 3) and are
normalised to x / 127.5 - 1, as images are loaded for this trunk.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# (name, in, out, kh, kw, stride): a BasicConv2d, padded as `padding` says
STEM = [("Conv2d_1a_3x3", 3, 32, 3, 3, 2),
        ("Conv2d_2a_3x3", 32, 32, 3, 3, 1),
        ("Conv2d_2b_3x3", 32, 64, 3, 3, 1), "pool",
        ("Conv2d_3b_1x1", 64, 80, 1, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3, 1), "pool"]
SAME = {"Conv2d_2b_3x3"}


def _a(prefix: str, cin: int, pool: int) -> List[tuple]:
    return [(f"{prefix}.branch1x1", cin, 64, 1, 1, 1),
            (f"{prefix}.branch5x5_1", cin, 48, 1, 1, 1),
            (f"{prefix}.branch5x5_2", 48, 64, 5, 5, 1),
            (f"{prefix}.branch3x3dbl_1", cin, 64, 1, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 64, 96, 3, 3, 1),
            (f"{prefix}.branch3x3dbl_3", 96, 96, 3, 3, 1),
            (f"{prefix}.branch_pool", cin, pool, 1, 1, 1)]


def _c(prefix: str, c7: int) -> List[tuple]:
    return [(f"{prefix}.branch1x1", 768, 192, 1, 1, 1),
            (f"{prefix}.branch7x7_1", 768, c7, 1, 1, 1),
            (f"{prefix}.branch7x7_2", c7, c7, 1, 7, 1),
            (f"{prefix}.branch7x7_3", c7, 192, 7, 1, 1),
            (f"{prefix}.branch7x7dbl_1", 768, c7, 1, 1, 1),
            (f"{prefix}.branch7x7dbl_2", c7, c7, 7, 1, 1),
            (f"{prefix}.branch7x7dbl_3", c7, c7, 1, 7, 1),
            (f"{prefix}.branch7x7dbl_4", c7, c7, 7, 1, 1),
            (f"{prefix}.branch7x7dbl_5", c7, 192, 1, 7, 1),
            (f"{prefix}.branch_pool", 768, 192, 1, 1, 1)]


def _e(prefix: str, cin: int) -> List[tuple]:
    return [(f"{prefix}.branch1x1", cin, 320, 1, 1, 1),
            (f"{prefix}.branch3x3_1", cin, 384, 1, 1, 1),
            (f"{prefix}.branch3x3_2a", 384, 384, 1, 3, 1),
            (f"{prefix}.branch3x3_2b", 384, 384, 3, 1, 1),
            (f"{prefix}.branch3x3dbl_1", cin, 448, 1, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 448, 384, 3, 3, 1),
            (f"{prefix}.branch3x3dbl_3a", 384, 384, 1, 3, 1),
            (f"{prefix}.branch3x3dbl_3b", 384, 384, 3, 1, 1),
            (f"{prefix}.branch_pool", cin, 192, 1, 1, 1)]


BLOCKS = {
    "Mixed_5b": ("A", _a("Mixed_5b", 192, 32)),
    "Mixed_5c": ("A", _a("Mixed_5c", 256, 64)),
    "Mixed_5d": ("A", _a("Mixed_5d", 288, 64)),
    "Mixed_6a": ("B", [("Mixed_6a.branch3x3", 288, 384, 3, 3, 2),
                       ("Mixed_6a.branch3x3dbl_1", 288, 64, 1, 1, 1),
                       ("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3, 1),
                       ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3, 2)]),
    "Mixed_6b": ("C", _c("Mixed_6b", 128)),
    "Mixed_6c": ("C", _c("Mixed_6c", 160)),
    "Mixed_6d": ("C", _c("Mixed_6d", 160)),
    "Mixed_6e": ("C", _c("Mixed_6e", 192)),
    "Mixed_7a": ("D", [("Mixed_7a.branch3x3_1", 768, 192, 1, 1, 1),
                       ("Mixed_7a.branch3x3_2", 192, 320, 3, 3, 2),
                       ("Mixed_7a.branch7x7x3_1", 768, 192, 1, 1, 1),
                       ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7, 1),
                       ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1, 1),
                       ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3, 2)]),
    "Mixed_7b": ("E", _e("Mixed_7b", 1280)),
    "Mixed_7c": ("E", _e("Mixed_7c", 2048)),
}
AUX = [("AuxLogits.conv0", 768, 128, 1, 1, 1),
       ("AuxLogits.conv1", 128, 768, 5, 5, 1)]
FC = [("AuxLogits.fc", 768, 1000), ("fc", 2048, 1000)]
FEATURE = 2048


def convolutions() -> List[tuple]:
    """Every BasicConv2d of the trunk, the feature's and the auxiliary
    head's: (name, in, out, kh, kw, stride)."""
    convs = [s for s in STEM if s != "pool"]
    for _, layers in BLOCKS.values():
        convs += layers
    return convs + AUX


def padding(name: str, kh: int, kw: int, stride: int) -> Tuple[int, int]:
    """A stride-1 convolution inside a block keeps the size; the stem's,
    the reductions' and the auxiliary head's are unpadded but
    Conv2d_2b's."""
    inside = "." in name and not name.startswith("AuxLogits")
    if stride == 1 and (inside or name in SAME):
        return kh // 2, kw // 2
    return 0, 0


def conv(p: Params, prefix: str, name: str, x: torch.Tensor,
         layer: tuple) -> torch.Tensor:
    _, _, _, kh, kw, stride = layer
    q = f"{prefix}{name}"
    y = F.conv2d(x, p[f"{q}.w"].permute(3, 2, 0, 1), stride=stride,
                 padding=padding(name, kh, kw, stride))
    return torch.relu(y * p[f"{q}.scale"][:, None, None]
                      + p[f"{q}.shift"][:, None, None])


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1)


def _block(p: Params, prefix: str, kind: str, layers: List[tuple],
           x: torch.Tensor) -> torch.Tensor:
    run = {layer[0]: layer for layer in layers}
    name = layers[0][0].split(".")[0]

    def c(branch, h):
        return conv(p, prefix, f"{name}.{branch}", h,
                    run[f"{name}.{branch}"])

    def chain(branches, h):
        for branch in branches:
            h = c(branch, h)
        return h

    if kind == "A":
        return torch.cat([
            c("branch1x1", x), chain(["branch5x5_1", "branch5x5_2"], x),
            chain(["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"], x),
            c("branch_pool", _pool(x))], dim=1)
    if kind == "B":
        return torch.cat([
            c("branch3x3", x),
            chain(["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"], x),
            F.max_pool2d(x, 3, 2)], dim=1)
    if kind == "C":
        return torch.cat([
            c("branch1x1", x),
            chain(["branch7x7_1", "branch7x7_2", "branch7x7_3"], x),
            chain([f"branch7x7dbl_{i}" for i in range(1, 6)], x),
            c("branch_pool", _pool(x))], dim=1)
    if kind == "D":
        return torch.cat([
            chain(["branch3x3_1", "branch3x3_2"], x),
            chain([f"branch7x7x3_{i}" for i in range(1, 5)], x),
            F.max_pool2d(x, 3, 2)], dim=1)
    b3 = c("branch3x3_1", x)
    bd = chain(["branch3x3dbl_1", "branch3x3dbl_2"], x)
    return torch.cat([
        c("branch1x1", x),
        torch.cat([c("branch3x3_2a", b3), c("branch3x3_2b", b3)], dim=1),
        torch.cat([c("branch3x3dbl_3a", bd), c("branch3x3dbl_3b", bd)],
                  dim=1),
        c("branch_pool", _pool(x))], dim=1)


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """uint8 pixel values -> float32 in [-1, 1]."""
    return frames.float() / 127.5 - 1.0


def features(p: Params, prefix: str, frames: torch.Tensor) -> torch.Tensor:
    """frames (N, H, W, 3) uint8 -> (N, 2048), the parameters under
    `prefix` (such as 'video_query.inception.')."""
    x = normalize(frames).permute(0, 3, 1, 2).contiguous()
    x = x.to(p[f"{prefix}Conv2d_1a_3x3.w"].dtype)
    for layer in STEM:
        if layer == "pool":
            x = F.max_pool2d(x, 3, 2)
        else:
            x = conv(p, prefix, layer[0], x, layer)
    for kind, layers in BLOCKS.values():
        x = _block(p, prefix, kind, layers, x)
    return x.mean(dim=(2, 3))


def features_in_blocks(p: Params, prefix: str, frames: torch.Tensor,
                       block: int) -> torch.Tensor:
    """`features` without autograd, `block` frames at a time, so that the
    activations of a step's thousands of frames need not fit at once."""
    with torch.no_grad():
        return torch.cat([features(p, prefix, frames[i:i + block])
                          for i in range(0, frames.shape[0], block)])
