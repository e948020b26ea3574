"""Inception-v3, the frozen video-frame trunk of the reference (the port of
`dl4ss_tpu/models/inception.py`).

Torch_multi/myNet.py (a torchvision Inception3 copy that also returns the
2048-d penultimate feature, myNet.py:123-128): BasicConv2d = conv +
batchnorm (eval mode) + relu, the A/B/C/D/E inception blocks, the aux head,
and a forward that returns (logits, aux_logits, penultimate). Inference-mode
batchnorm only (the reference freezes the whole trunk,
main_run.py:232-235), folded into `scale` / `shift`. Parameters are named
like the JAX pytree (torchvision's module names), kernels HWIO, so a JAX
tree loads leaf for leaf (`weights.load_jax_params`); a torchvision
state_dict goes through `load_torch_state_dict`. The forward runs NCHW
through `F.conv2d` (cuDNN on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.common import Linear, conv2d_nchw


class BasicConv2d(nn.Module):
    """conv (no bias) + folded eval-mode batchnorm: `w` (kh, kw, in, out),
    `scale` = gamma / sqrt(var + eps), `shift` = beta - mean * scale."""

    def __init__(self, in_ch: int, out_ch: int, kh: int, kw: int,
                 generator=None, device=None):
        super().__init__()
        w = torch.empty((kh, kw, in_ch, out_ch), dtype=torch.float32)
        # he-normal-ish (truncated normal), as JAX's init
        nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
        w *= float(np.sqrt(2.0 / (in_ch * kh * kw)))
        self.w = nn.Parameter(w.to(device))
        self.scale = nn.Parameter(torch.ones(out_ch, device=device))
        self.shift = nn.Parameter(torch.zeros(out_ch, device=device))


def _fc(in_dim: int, out_dim: int, generator, device) -> Linear:
    fc = Linear(in_dim, out_dim, generator=generator, device=device)
    with torch.no_grad():
        w = torch.empty((in_dim, out_dim))
        w.normal_(generator=generator)
        fc.w.copy_(0.001 * w)
        fc.b.zero_()
    return fc


class InceptionV3(nn.Module):
    """Parameter tree mirroring torchvision's module names."""

    def __init__(self, num_classes: int = 1000, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)

        def conv(i, o, kh, kw):
            return BasicConv2d(i, o, kh, kw, generator, device)

        def block(**convs):
            return nn.ModuleDict({k: conv(*v) for k, v in convs.items()})

        self.Conv2d_1a_3x3 = conv(3, 32, 3, 3)
        self.Conv2d_2a_3x3 = conv(32, 32, 3, 3)
        self.Conv2d_2b_3x3 = conv(32, 64, 3, 3)
        self.Conv2d_3b_1x1 = conv(64, 80, 1, 1)
        self.Conv2d_4a_3x3 = conv(80, 192, 3, 3)

        def block_a(in_ch, pool_ch):
            return block(
                branch1x1=(in_ch, 64, 1, 1), branch5x5_1=(in_ch, 48, 1, 1),
                branch5x5_2=(48, 64, 5, 5), branch3x3dbl_1=(in_ch, 64, 1, 1),
                branch3x3dbl_2=(64, 96, 3, 3), branch3x3dbl_3=(96, 96, 3, 3),
                branch_pool=(in_ch, pool_ch, 1, 1))

        self.Mixed_5b = block_a(192, 32)
        self.Mixed_5c = block_a(256, 64)
        self.Mixed_5d = block_a(288, 64)
        self.Mixed_6a = block(
            branch3x3=(288, 384, 3, 3), branch3x3dbl_1=(288, 64, 1, 1),
            branch3x3dbl_2=(64, 96, 3, 3), branch3x3dbl_3=(96, 96, 3, 3))

        def block_c(ch7):
            return block(
                branch1x1=(768, 192, 1, 1), branch7x7_1=(768, ch7, 1, 1),
                branch7x7_2=(ch7, ch7, 1, 7), branch7x7_3=(ch7, 192, 7, 1),
                branch7x7dbl_1=(768, ch7, 1, 1),
                branch7x7dbl_2=(ch7, ch7, 7, 1),
                branch7x7dbl_3=(ch7, ch7, 1, 7),
                branch7x7dbl_4=(ch7, ch7, 7, 1),
                branch7x7dbl_5=(ch7, 192, 1, 7),
                branch_pool=(768, 192, 1, 1))

        self.Mixed_6b = block_c(128)
        self.Mixed_6c = block_c(160)
        self.Mixed_6d = block_c(160)
        self.Mixed_6e = block_c(192)
        self.AuxLogits = nn.ModuleDict({
            "conv0": conv(768, 128, 1, 1), "conv1": conv(128, 768, 5, 5),
            "fc": _fc(768, num_classes, generator, device)})
        self.Mixed_7a = block(
            branch3x3_1=(768, 192, 1, 1), branch3x3_2=(192, 320, 3, 3),
            branch7x7x3_1=(768, 192, 1, 1), branch7x7x3_2=(192, 192, 1, 7),
            branch7x7x3_3=(192, 192, 7, 1), branch7x7x3_4=(192, 192, 3, 3))

        def block_e(in_ch):
            return block(
                branch1x1=(in_ch, 320, 1, 1), branch3x3_1=(in_ch, 384, 1, 1),
                branch3x3_2a=(384, 384, 1, 3), branch3x3_2b=(384, 384, 3, 1),
                branch3x3dbl_1=(in_ch, 448, 1, 1),
                branch3x3dbl_2=(448, 384, 3, 3),
                branch3x3dbl_3a=(384, 384, 1, 3),
                branch3x3dbl_3b=(384, 384, 3, 1),
                branch_pool=(in_ch, 192, 1, 1))

        self.Mixed_7b = block_e(1280)
        self.Mixed_7c = block_e(2048)
        self.fc = _fc(2048, num_classes, generator, device)


def init_inception_v3(num_classes: int = 1000, generator=None, device=None
                      ) -> InceptionV3:
    """Random-initialised trunk on `device` (`cuda` unless device='cpu')."""
    return InceptionV3(num_classes, generator, device)


def _basic_conv(p: BasicConv2d, x: torch.Tensor, stride=(1, 1),
                padding: str = "VALID") -> torch.Tensor:
    y = conv2d_nchw(x, p.w, stride, padding)
    scale, shift = p.scale[:, None, None], p.shift[:, None, None]
    if torch.is_grad_enabled():
        return F.relu(y * scale + shift)
    # the frozen trunk: the same arithmetic in place, so that a layer holds
    # its input and its output and no temporaries (thousands of 299x299
    # frames a step)
    return y.mul_(scale).add_(shift).relu_()


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool whose divisor is always 9, padding
    included (torchvision's F.avg_pool2d(count_include_pad=True))."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _block_a_fwd(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b5 = _basic_conv(p["branch5x5_2"], _basic_conv(p["branch5x5_1"], x),
                     padding="SAME")
    b3 = _basic_conv(p["branch3x3dbl_1"], x)
    b3 = _basic_conv(p["branch3x3dbl_2"], b3, padding="SAME")
    b3 = _basic_conv(p["branch3x3dbl_3"], b3, padding="SAME")
    bp = _basic_conv(p["branch_pool"], _avg_pool(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_c_fwd(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b7 = _basic_conv(p["branch7x7_1"], x)
    b7 = _basic_conv(p["branch7x7_2"], b7, padding="SAME")
    b7 = _basic_conv(p["branch7x7_3"], b7, padding="SAME")
    bd = _basic_conv(p["branch7x7dbl_1"], x)
    for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4",
                 "branch7x7dbl_5"):
        bd = _basic_conv(p[name], bd, padding="SAME")
    bp = _basic_conv(p["branch_pool"], _avg_pool(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_e_fwd(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b3 = _basic_conv(p["branch3x3_1"], x)
    b3 = torch.cat([_basic_conv(p["branch3x3_2a"], b3, padding="SAME"),
                    _basic_conv(p["branch3x3_2b"], b3, padding="SAME")], dim=1)
    bd = _basic_conv(p["branch3x3dbl_1"], x)
    bd = _basic_conv(p["branch3x3dbl_2"], bd, padding="SAME")
    bd = torch.cat([_basic_conv(p["branch3x3dbl_3a"], bd, padding="SAME"),
                    _basic_conv(p["branch3x3dbl_3b"], bd, padding="SAME")],
                   dim=1)
    bp = _basic_conv(p["branch_pool"], _avg_pool(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


def apply_inception_v3(p: InceptionV3, x: torch.Tensor, aux: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """x: (B, 299, 299, 3) NHWC in [-1, 1] (torchvision normalization is
    the caller's job). Returns (logits, aux_logits or None, penultimate
    2048-d), the 3-tuple the reference's VIDEO_QUERY consumes through
    `[2]` (main_run.py:234)."""
    x = x.permute(0, 3, 1, 2).float()
    x = _basic_conv(p.Conv2d_1a_3x3, x, stride=(2, 2))
    x = _basic_conv(p.Conv2d_2a_3x3, x)
    x = _basic_conv(p.Conv2d_2b_3x3, x, padding="SAME")
    x = F.max_pool2d(x, 3, 2)
    x = _basic_conv(p.Conv2d_3b_1x1, x)
    x = _basic_conv(p.Conv2d_4a_3x3, x)
    x = F.max_pool2d(x, 3, 2)
    x = _block_a_fwd(p.Mixed_5b, x)
    x = _block_a_fwd(p.Mixed_5c, x)
    x = _block_a_fwd(p.Mixed_5d, x)
    pa = p.Mixed_6a                                   # grid reduction
    b3 = _basic_conv(pa["branch3x3"], x, stride=(2, 2))
    bd = _basic_conv(pa["branch3x3dbl_1"], x)
    bd = _basic_conv(pa["branch3x3dbl_2"], bd, padding="SAME")
    bd = _basic_conv(pa["branch3x3dbl_3"], bd, stride=(2, 2))
    x = torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)
    for blk in (p.Mixed_6b, p.Mixed_6c, p.Mixed_6d, p.Mixed_6e):
        x = _block_c_fwd(blk, x)
    aux_logits = None
    if aux:
        a = F.avg_pool2d(x, 5, 3)
        a = _basic_conv(p.AuxLogits["conv0"], a)
        a = _basic_conv(p.AuxLogits["conv1"], a)
        a = a.mean(dim=(2, 3))
        fc = p.AuxLogits["fc"]
        aux_logits = a @ fc.w + fc.b
    pa = p.Mixed_7a                                   # grid reduction
    b3 = _basic_conv(pa["branch3x3_2"], _basic_conv(pa["branch3x3_1"], x),
                     stride=(2, 2))
    b7 = _basic_conv(pa["branch7x7x3_1"], x)
    b7 = _basic_conv(pa["branch7x7x3_2"], b7, padding="SAME")
    b7 = _basic_conv(pa["branch7x7x3_3"], b7, padding="SAME")
    b7 = _basic_conv(pa["branch7x7x3_4"], b7, stride=(2, 2))
    x = torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)
    x = _block_e_fwd(p.Mixed_7b, x)
    x = _block_e_fwd(p.Mixed_7c, x)
    hidden = x.mean(dim=(2, 3))                       # (B, 2048)
    logits = hidden @ p.fc.w + p.fc.b
    return logits, aux_logits, hidden


def load_torch_state_dict(path_or_dict, num_classes: int = 1000,
                          eps: float = 1e-3) -> Dict:
    """A torchvision inception_v3 state_dict (.pth path or dict) as a
    JAX-style parameter tree of float32 numpy arrays (load it with
    `weights.load_jax_params`), eval-mode batchnorm folded into
    scale / shift."""
    from dl4ss_tpu_torch.weights import export_jax_params
    if not isinstance(path_or_dict, dict):
        path_or_dict = torch.load(path_or_dict, map_location="cpu",
                                  weights_only=True)
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
          for k, v in path_or_dict.items()}
    params = export_jax_params(InceptionV3(num_classes, device="cpu"))

    def fill(dst, prefix):
        if "scale" in dst:                            # BasicConv2d
            dst["w"] = np.transpose(sd[prefix + ".conv.weight"],
                                    (2, 3, 1, 0)).astype(np.float32)
            scale = sd[prefix + ".bn.weight"] / np.sqrt(
                sd[prefix + ".bn.running_var"] + eps)
            dst["scale"] = scale.astype(np.float32)
            dst["shift"] = (sd[prefix + ".bn.bias"]
                            - sd[prefix + ".bn.running_mean"] * scale
                            ).astype(np.float32)
        elif "b" in dst:                              # Linear
            dst["w"] = np.transpose(sd[prefix + ".weight"]).astype(np.float32)
            dst["b"] = sd[prefix + ".bias"].astype(np.float32)
        else:
            for k in dst:
                fill(dst[k], f"{prefix}.{k}")

    for top, dst in params.items():
        fill(dst, top)
    return params
