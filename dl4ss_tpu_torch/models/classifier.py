"""Multi-label "who is in the mixture" speaker classifier (the port of
`dl4ss_tpu/models/classifier.py`).

A BiLSTM over the magnitude features, the mean over time, then
sigmoid(Linear -> num_speakers). `classifier_hidden_mult` doubles the
recurrent width for the TDAA forks. Under cfg.use_pallas_rnn the BiLSTM
runs on K7 and trains through K8 (ops/rnn_kernels.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.common import linear, linear_init
from dl4ss_tpu_torch.ops.rnn import bidirectional_rnn, rnn_init


class Classifier(nn.Module):
    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        width = cfg.hidden_units * cfg.classifier_hidden_mult
        self.rnn = rnn_init(cfg.classifier_rnn, cfg.freq_bins, width,
                            cfg.classifier_layers, generator, device=device)
        self.out = linear_init(2 * width, cfg.num_speakers,
                               generator=generator, device=device)

    def forward(self, feat, cfg: Config, logits: bool = False):
        """`apply_classifier` on this module's parameters, so that
        `torch.func.functional_call` can run it on substituted ones (the
        trainer's bf16 casts of the f32 masters)."""
        return apply_classifier(self, feat, cfg, logits=logits)


def init_classifier(cfg: Config, generator: Optional[torch.Generator] = None,
                    device=None) -> Classifier:
    """On `device`: `cuda` unless the caller passes device='cpu'."""
    return Classifier(cfg, generator, device)


def apply_classifier(params: Classifier, feat: torch.Tensor, cfg: Config,
                     logits: bool = False) -> torch.Tensor:
    """feat (B, T, F) -> per-speaker presence probabilities (B, S), or the
    logits before the sigmoid."""
    hidden = bidirectional_rnn(params.rnn, feat, cfg.classifier_rnn,
                               use_pallas=cfg.use_pallas_rnn, remat=cfg.remat)
    out = linear(params.out, hidden.mean(dim=1))
    return out if logits else torch.sigmoid(out)
