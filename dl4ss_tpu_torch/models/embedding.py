"""Speaker embedding table (the port of `dl4ss_tpu/models/embedding.py`).

An (num_speakers, Q) table — Q = 2E for the cRM dual-query path — read by
direct gather (`apply_embedding`, the dB/TDAA signature) or, for the dense
all-speaker channel layout, by the gated read (`apply_embedding_gated`,
main_run.py:307-327).

Under a mesh with a model axis (parallel/mesh.py) the table may be
row-sharded: `shard` then says which rows this rank holds, and a lookup
reads the local rows, zeroes the others and sums over the model group.
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
        self.shard = None      # a parallel.mesh.RowShard once row-sharded


def init_embedding(cfg: Config, generator: Optional[torch.Generator] = None,
                   device=None) -> Embedding:
    """On `device`: `cuda` unless the caller passes device='cpu'."""
    return Embedding(cfg, generator, device)


def _rows(params: Embedding, idx: torch.Tensor) -> torch.Tensor:
    """table[idx], from the local rows of a row-sharded table when it is
    one."""
    shard = params.shard
    if shard is None:
        return params.table[idx]
    n = params.table.shape[0]
    local = idx - shard.start
    mine = (local >= 0) & (local < n)
    rows = params.table[local.clamp(0, n - 1)] * mine[..., None]
    return shard.mesh.model_sum(rows)


def apply_embedding(params: Embedding, spk_idx: torch.Tensor) -> torch.Tensor:
    """(B, K) int -> (B, K, Q)."""
    return _rows(params, spk_idx)


def apply_embedding_gated(params: Embedding, channel_gate: torch.Tensor
                          ) -> torch.Tensor:
    """channel_gate (B, S) in {0,1} -> (B, S, Q), zeroed where the gate is
    0: every speaker owns a channel, absent ones read row 0 and are
    zeroed (main_run.py:307-327)."""
    s = params.table.shape[0] if params.shard is None else params.shard.rows
    idx = (torch.arange(s, device=channel_gate.device)[None, :]
           * channel_gate.to(torch.int64))
    emb = _rows(params, idx)
    return emb * channel_gate[..., None].to(emb.dtype)
