"""Spectrogram realness discriminator, TDAA's adversarial refinement (the
port of `dl4ss_tpu/models/discriminator.py`).

3 x [Conv 3x3 stride 2 VALID, 64 channels, ReLU] over (T, F) spectrograms
viewed as one-channel images, then Linear(flatten -> 1) + sigmoid
(TDAA_beta/main_run_sstune_TestVer.py:335-353). The activations are NHWC
and the flatten runs in that order, so `out.w`'s rows are laid out as in
JAX: for the reference shape (313, 129) that is 38*15*64 = 36480.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.models.common import (conv2d, conv_init, linear,
                                           linear_init)


def _out_hw(t: int, f: int) -> Tuple[int, int]:
    for _ in range(3):
        t = (t - 3) // 2 + 1
        f = (f - 3) // 2 + 1
    return t, f


class Discriminator(nn.Module):
    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None, num_frames: Optional[int] = None):
        super().__init__()
        t = num_frames if num_frames is not None else cfg.num_frames
        th, fw = _out_hw(t, cfg.freq_bins)
        self.conv0 = conv_init(1, 64, 3, 3, generator, device=device)
        self.conv1 = conv_init(64, 64, 3, 3, generator, device=device)
        self.conv2 = conv_init(64, 64, 3, 3, generator, device=device)
        self.out = linear_init(th * fw * 64, 1, generator=generator,
                               device=device)


def init_discriminator(cfg: Config,
                       generator: Optional[torch.Generator] = None,
                       device=None, num_frames: Optional[int] = None
                       ) -> Discriminator:
    """On `device`: `cuda` unless the caller passes device='cpu'. Its
    output layer is sized for spectrograms of `num_frames` frames
    (default cfg.num_frames)."""
    return Discriminator(cfg, generator, device, num_frames)


def apply_discriminator(params: Discriminator, specs: torch.Tensor,
                        cfg: Config) -> torch.Tensor:
    """specs (B, K, T, F) -> realness scores (B*K, 1) in (0, 1)."""
    b, k, t, f = specs.shape
    x = specs.reshape(b * k, t, f, 1)
    for conv in (params.conv0, params.conv1, params.conv2):
        x = torch.relu(conv2d(conv, x, stride=(2, 2)))
    return torch.sigmoid(linear(params.out, x.reshape(b * k, -1)))
