"""Speaker embedding table (the port of `dl4ss_tpu/models/embedding.py`).

An (num_speakers, Q) table — Q = 2E for the cRM dual-query path — read by
direct gather (`apply_embedding`). The all-speaker gated read comes with
the dense channel layout (training, ROADMAP P6).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device


class Embedding(nn.Module):
    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        # torch nn.Embedding default: N(0, 1)
        table = torch.randn((cfg.num_speakers, cfg.query_dim),
                            generator=generator)
        self.table = nn.Parameter(table.to(device))


def init_embedding(cfg: Config, generator: Optional[torch.Generator] = None,
                   device=None) -> Embedding:
    """On `device`: `cuda` unless the caller passes device='cpu'."""
    return Embedding(cfg, generator, device)


def apply_embedding(params: Embedding, spk_idx: torch.Tensor) -> torch.Tensor:
    """(B, K) int -> (B, K, Q)."""
    return params.table[spk_idx]

