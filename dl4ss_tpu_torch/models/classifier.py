"""Multi-label speaker classifier parameters (the port of
`dl4ss_tpu/models/classifier.py`).

Only the parameters for now, so the separator's tree is whole and JAX
checkpoints load leaf for leaf: running the classifier's BiLSTM on the card
waits for the LSTM kernel K7 (ROADMAP P8).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.common import linear_init
from dl4ss_tpu_torch.ops.rnn import rnn_init


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


def init_classifier(cfg: Config, generator: Optional[torch.Generator] = None,
                    device=None) -> Classifier:
    """On `device`: `cuda` unless the caller passes device='cpu'."""
    return Classifier(cfg, generator, device)
