"""The composed speaker-conditioned separation model (the port of
`dl4ss_tpu/models/separator.py`, top-k layout).

encoder -> query (speaker embedding, or given queries) -> mask head -> mask
apply. Speakers are given: classifier selection waits for the BiLSTM
kernel K7 (ROADMAP P8); ADDJUST, the discriminator and cRM wait for TDAA
(ROADMAP P9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.attention import apply_mask_head, init_mask_head
from dl4ss_tpu_torch.models.classifier import init_classifier
from dl4ss_tpu_torch.models.embedding import apply_embedding, init_embedding
from dl4ss_tpu_torch.models.encoder import (apply_encoder, encoder_hidden,
                                            init_encoder)


class SeparatorOutput(NamedTuple):
    masks: torch.Tensor     # (B,K,T,F)
    pred: torch.Tensor      # masked magnitudes (B,K,T,F)
    probs: torch.Tensor     # classifier probabilities (B,S); zeros here
    hidden: torch.Tensor    # encoder hidden (B,T,2H)
    queries: torch.Tensor   # queries (B,K,Q)


class Separator(nn.Module):
    """Parameter tree named like the JAX `init_separator` pytree, on
    `device` (default `cuda`; raises without a GPU unless device='cpu')."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = init_encoder(cfg, generator, device)
        self.classifier = init_classifier(cfg, generator, device)
        self.embedding = init_embedding(cfg, generator, device)
        self.mask_head = init_mask_head(cfg, generator, device)


def _check_ported(cfg: Config) -> None:
    if cfg.is_self_tune or cfg.use_discriminator:
        raise NotImplementedError(
            "ADDJUST (is_self_tune) and the discriminator are not ported yet "
            "(TDAA, ROADMAP P9)")


def init_separator(cfg: Config, generator: Optional[torch.Generator] = None,
                   device=None) -> Separator:
    """Random-initialised separator on `device` (default `cuda`; raises
    without a GPU unless device='cpu'). Weights are drawn on the CPU from
    `generator`, so a seed gives the same model on every device."""
    _check_ported(cfg)
    return Separator(cfg, generator, device)


def _use_fused_maskhead(cfg: Config) -> bool:
    """The fused proj+dot+sigmoid kernel (K3) replaces the embedding-grid
    materialisation; magnitude dot-head configs only. (The JAX package's
    VMEM byte guard is a TPU limit and has no counterpart here.)"""
    return (cfg.use_pallas_maskhead and cfg.mask_head == "dot"
            and not cfg.is_complex_mask)


def _finish(params: Separator, cfg: Config, emb_map, hidden, queries, feat,
            mix_ri, probs) -> SeparatorOutput:
    if emb_map is None:
        # fused path: the (B,T,F,E) grid never exists in device memory
        from dl4ss_tpu_torch.ops.maskhead_kernels import fused_dot_masks
        proj = params.encoder.proj
        masks = fused_dot_masks(hidden, proj.w, proj.b,
                                queries.to(hidden.dtype), cfg.freq_bins,
                                cfg.embedding_size)
    else:
        masks = apply_mask_head(params.mask_head, emb_map, queries, cfg)
    if cfg.log_spectral:
        # log features drive the mask, but the mask multiplies the LINEAR
        # spectrum (Cocktail nnet.py:95, predict.py:241-245)
        if mix_ri is None:
            raise ValueError(
                "log_spectral separation needs mix_ri (the packed complex "
                "mixture) to recover the linear magnitude the masks apply to")
        mag = torch.sqrt(mix_ri[..., 0] ** 2 + mix_ri[..., 1] ** 2)
        pred = masks * mag.to(masks.dtype)[:, None]
    else:
        pred = masks * feat[:, None]
    return SeparatorOutput(masks, pred, probs, hidden, queries)


def separate(params: Separator, feat: torch.Tensor, cfg: Config,
             spk_idx: Optional[torch.Tensor] = None,
             queries: Optional[torch.Tensor] = None,
             mix_ri: Optional[torch.Tensor] = None) -> SeparatorOutput:
    """Top-k path. feat (B,T,F) magnitude features.

    spk_idx (B,K): the speakers to extract. `queries` (B,K,Q) overrides
    the embedding lookup. `mix_ri` (B,T,F,2) is the packed mixture, needed
    by log-spectral configs.
    """
    _check_ported(cfg)
    if spk_idx is None and queries is None:
        raise NotImplementedError(
            "classifier-selected speakers need the BiLSTM kernel K7 "
            "(ROADMAP P8); pass spk_idx or queries")
    if _use_fused_maskhead(cfg):
        emb_map, hidden = None, encoder_hidden(params.encoder, feat, cfg)
    else:
        emb_map, hidden = apply_encoder(params.encoder, feat, cfg)
    probs = torch.zeros((feat.shape[0], cfg.num_speakers), dtype=feat.dtype,
                        device=feat.device)
    if queries is None:
        queries = apply_embedding(params.embedding, spk_idx)
    return _finish(params, cfg, emb_map, hidden, queries, feat, mix_ri, probs)
