"""Mixture encoder: (B, T, F) magnitude features -> 3-D embedding map.

The port of `dl4ss_tpu/models/encoder.py`: a multi-layer bidirectional RNN
followed by a Dense(2H -> F*E) with tanh, reshaped to the (B, T, F, E)
time-frequency embedding grid the mask heads attend over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.common import linear, linear_init
from dl4ss_tpu_torch.ops.rnn import bidirectional_rnn, rnn_init


class Encoder(nn.Module):
    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.rnn = rnn_init(cfg.encoder_rnn, cfg.freq_bins, cfg.hidden_units,
                            cfg.encoder_layers, generator, device=device)
        self.proj = linear_init(2 * cfg.hidden_units,
                                cfg.freq_bins * cfg.embedding_size,
                                generator=generator, device=device)


def init_encoder(cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None) -> Encoder:
    """On `device`: `cuda` unless the caller passes device='cpu'."""
    return Encoder(cfg, generator, device)


def encoder_hidden(params: Encoder, feat: torch.Tensor, cfg: Config
                   ) -> torch.Tensor:
    """feat (B, T, F) -> recurrent hidden (B, T, 2H): the RNN half alone,
    which the fused mask head consumes without the embedding grid."""
    return bidirectional_rnn(params.rnn, feat, cfg.encoder_rnn,
                             use_pallas=cfg.use_pallas_rnn, remat=cfg.remat)


def embedding_map(params: Encoder, hidden: torch.Tensor, cfg: Config
                  ) -> torch.Tensor:
    """hidden (B, T, 2H) -> (B, T, F, E) tanh embedding grid."""
    b, t, _ = hidden.shape
    emb = torch.tanh(linear(params.proj, hidden))
    return emb.reshape(b, t, cfg.freq_bins, cfg.embedding_size)


def apply_encoder(params: Encoder, feat: torch.Tensor, cfg: Config
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat (B, T, F) -> (emb_map (B, T, F, E), hidden (B, T, 2H))."""
    hidden = encoder_hidden(params, feat, cfg)
    return embedding_map(params, hidden, cfg), hidden
