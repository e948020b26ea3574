"""ADDJUST — TDAA's "self-tune" query adaptation (the port of
`dl4ss_tpu/models/adjust.py`).

The time-mean of the encoder hidden sequence is concatenated with each
speaker query and passed through a bias-free Linear(2H+Q -> Q); the result
is added to the query (`emb <- emb + ADDJUST(hidden, emb)`,
TDAA_beta/main_run_sstune_TestVer.py:370-384, :453-454), under
cfg.is_self_tune.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.models.common import linear, linear_init


class Adjust(nn.Module):
    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.layer = linear_init(2 * cfg.hidden_units + cfg.query_dim,
                                 cfg.query_dim, bias=False,
                                 generator=generator, device=device)


def init_adjust(cfg: Config, generator: Optional[torch.Generator] = None,
                device=None) -> Adjust:
    """On `device`: `cuda` unless the caller passes device='cpu'."""
    return Adjust(cfg, generator, device)


def apply_adjust(params: Adjust, hidden: torch.Tensor, queries: torch.Tensor
                 ) -> torch.Tensor:
    """hidden (B,T,2H), queries (B,K,Q) -> adjusted queries (B,K,Q)."""
    ctx = hidden.mean(dim=1)                                 # (B, 2H)
    ctx = ctx[:, None, :].expand(-1, queries.shape[1], -1)
    return queries + linear(params.layer, torch.cat([ctx, queries], dim=-1))
