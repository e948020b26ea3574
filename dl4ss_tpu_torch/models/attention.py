"""Mask heads: query-vs-grid attention emitting time-frequency masks.

The port of `dl4ss_tpu/models/attention.py`:
  * `dot`:   sigmoid(<emb_map[b,t,f,:], query[b,k,:]>) over the (T, F) grid
  * `align`: sigmoid(v . tanh(W1 g + W2 q)) additive attention
The complex-ratio-mask (cRM) variants come with TDAA (ROADMAP P9).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.common import linear_init


class MaskHead(nn.Module):
    """Parameters of the `align` head; the `dot` head has none."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        if cfg.mask_head == "dot":
            return
        e = a = cfg.embedding_size
        self.w_grid = linear_init(e, a, False, generator, device=device)
        self.w_query = linear_init(e, a, False, generator, device=device)
        self.v = linear_init(a, 1, False, generator, device=device)


def init_mask_head(cfg: Config, generator: Optional[torch.Generator] = None,
                   device=None) -> MaskHead:
    """On `device`: `cuda` unless the caller passes device='cpu'."""
    return MaskHead(cfg, generator, device)


def _dot_energy(emb_map: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B,T,F,E) x (B,K,E) -> (B,K,T,F)."""
    return torch.einsum("btfe,bke->bktf", emb_map.float(),
                        queries.float()).to(emb_map.dtype)


def _align_energy(params: MaskHead, emb_map: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("btfe,ea->btfa", emb_map.float(),
                     params.w_grid.w.float())
    q = torch.einsum("bke,ea->bka", queries.float(), params.w_query.w.float())
    v = params.v.w.float()
    outs = []
    for ki in range(queries.shape[1]):   # K small: no (B,K,T,F,A) tensor
        s = torch.tanh(g + q[:, ki][:, None, None, :])
        outs.append(torch.einsum("btfa,ax->btf", s, v))
    return torch.stack(outs, dim=1).to(emb_map.dtype)


def apply_mask_head(params: MaskHead, emb_map: torch.Tensor,
                    queries: torch.Tensor, cfg: Config) -> torch.Tensor:
    """emb_map (B,T,F,E), queries (B,K,E) -> (B,K,T,F) sigmoid masks."""
    if cfg.is_complex_mask:
        raise NotImplementedError(
            "the complex-ratio-mask head is not ported yet (TDAA, ROADMAP "
            "P9)")
    if cfg.mask_head == "dot":
        energy = _dot_energy(emb_map, queries)
    else:
        energy = _align_energy(params, emb_map, queries)
    return torch.sigmoid(energy)
