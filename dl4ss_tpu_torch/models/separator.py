"""The composed speaker-conditioned separation model (the port of
`dl4ss_tpu/models/separator.py`, top-k layout).

encoder -> query (speaker embedding, or given queries) -> optional ADDJUST
-> mask head -> mask apply (sigmoid masks on the magnitude, or the
uncompressed cRM on the complex mixture). The speakers are given, or picked
by the classifier (its top-k); `separate_dense` gives every speaker a
0/1-gated channel (main_run.py:473-489); `recursive_separate` peels one
classifier-chosen speaker per step. TDAA's discriminator is a parameter
subtree here and runs only in the adversarial trainer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.adjust import apply_adjust, init_adjust
from dl4ss_tpu_torch.models.attention import apply_mask_head, init_mask_head
from dl4ss_tpu_torch.models.classifier import (apply_classifier,
                                               init_classifier)
from dl4ss_tpu_torch.models.discriminator import init_discriminator
from dl4ss_tpu_torch.models.embedding import (apply_embedding,
                                              apply_embedding_gated,
                                              init_embedding)
from dl4ss_tpu_torch.models.encoder import (apply_encoder, encoder_hidden,
                                            init_encoder)
from dl4ss_tpu_torch.objectives.select import top_k_indices
from dl4ss_tpu_torch.ops.crm import complex_mask_apply, crm_uncompress


class SeparatorOutput(NamedTuple):
    masks: torch.Tensor     # (B,K,T,F) or compressed cRM (B,K,T,F,2)
    pred: torch.Tensor      # masked magnitudes (B,K,T,F) or complex RI (...,2)
    probs: torch.Tensor     # classifier probabilities (B,S)
    hidden: torch.Tensor    # encoder hidden (B,T,2H)
    queries: torch.Tensor   # final (post-ADDJUST) queries (B,K,Q)


class Separator(nn.Module):
    """Parameter tree named like the JAX `init_separator` pytree, on
    `device` (default `cuda`; raises without a GPU unless device='cpu')."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 device=None, num_frames: Optional[int] = None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = init_encoder(cfg, generator, device)
        self.classifier = init_classifier(cfg, generator, device)
        self.embedding = init_embedding(cfg, generator, device)
        self.mask_head = init_mask_head(cfg, generator, device)
        if cfg.is_self_tune:
            self.adjust = init_adjust(cfg, generator, device)
        if cfg.use_discriminator:
            self.discriminator = init_discriminator(cfg, generator, device,
                                                    num_frames)

    def forward(self, feat, cfg: Config, spk_idx=None, queries=None,
                mix_ri=None, need_probs=False, channel_gate=None
                ) -> "SeparatorOutput":
        """`separate` (or, given `channel_gate`, `separate_dense`) on this
        module's parameters, so that `torch.func.functional_call` can run
        it on substituted ones (the trainer's bf16 casts of the f32
        masters)."""
        if channel_gate is not None:
            return separate_dense(self, feat, cfg, channel_gate, mix_ri=mix_ri)
        return separate(self, feat, cfg, spk_idx=spk_idx, queries=queries,
                        mix_ri=mix_ri, need_probs=need_probs)


def init_separator(cfg: Config, generator: Optional[torch.Generator] = None,
                   device=None, num_frames: Optional[int] = None
                   ) -> Separator:
    """Random-initialised separator on `device` (default `cuda`; raises
    without a GPU unless device='cpu'). Weights are drawn on the CPU from
    `generator`, so a seed gives the same model on every device. With
    cfg.is_self_tune it has an `adjust` subtree, with cfg.use_discriminator
    a `discriminator` for spectrograms of `num_frames` frames (default
    cfg.num_frames)."""
    return Separator(cfg, generator, device, num_frames)


def classify_speakers(params: Separator, feat: torch.Tensor, cfg: Config,
                      logits: bool = False) -> torch.Tensor:
    return apply_classifier(params.classifier, feat, cfg, logits=logits)


def _use_fused_maskhead(cfg: Config) -> bool:
    """The fused proj+dot+sigmoid kernel (K3) replaces the embedding-grid
    materialisation; magnitude dot-head configs only (align heads and cRM
    keep the plain head). The JAX package's VMEM byte guard is a TPU limit
    and has no counterpart here."""
    return (cfg.use_pallas_maskhead and cfg.mask_head == "dot"
            and not cfg.is_complex_mask)


def _finish(params: Separator, cfg: Config, emb_map, hidden, queries, feat,
            mix_ri, probs) -> SeparatorOutput:
    if cfg.is_self_tune:
        queries = apply_adjust(params.adjust, hidden, queries)
    if emb_map is None:
        # fused path: the (B,T,F,E) grid never exists in device memory
        from dl4ss_tpu_torch.ops.maskhead_kernels import fused_dot_masks
        proj = params.encoder.proj
        masks = fused_dot_masks(hidden, proj.w, proj.b,
                                queries.to(hidden.dtype), cfg.freq_bins,
                                cfg.embedding_size)
    else:
        masks = apply_mask_head(params.mask_head, emb_map, queries, cfg)
    if cfg.is_complex_mask:
        # uncompress the K*tanh-bounded head output, then complex-multiply
        # with the mixture spectrum (main_run_sstune_cRM_EvalVer.py:512,
        # 552-553)
        if mix_ri is None:
            raise ValueError("cRM separation needs mix_ri (the packed "
                             "complex mixture) to apply the complex masks to")
        pred = complex_mask_apply(crm_uncompress(masks, cfg.crm_k, cfg.crm_c),
                                  mix_ri[:, None])
    elif cfg.log_spectral:
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
             mix_ri: Optional[torch.Tensor] = None,
             need_probs: bool = False) -> SeparatorOutput:
    """Top-k path. feat (B,T,F) magnitude features.

    spk_idx (B,K): the speakers to extract; if None (and no `queries`),
    the classifier's top-k. `queries` (B,K,Q) overrides the embedding
    lookup. `mix_ri` (B,T,F,2) is the packed mixture, needed by
    log-spectral and cRM configs.

    The classifier (a BiLSTM as large as the encoder) runs only when its
    output is needed: when it selects the speakers, or when `need_probs`
    asks for it. Selection indices carry no gradient.
    """
    if _use_fused_maskhead(cfg):
        emb_map, hidden = None, encoder_hidden(params.encoder, feat, cfg)
    else:
        emb_map, hidden = apply_encoder(params.encoder, feat, cfg)
    if need_probs or (queries is None and spk_idx is None):
        probs = apply_classifier(params.classifier, feat, cfg)
    else:
        probs = torch.zeros((feat.shape[0], cfg.num_speakers),
                            dtype=feat.dtype, device=feat.device)
    if queries is None:
        if spk_idx is None:
            spk_idx, _ = top_k_indices(probs, cfg.top_k)
        queries = apply_embedding(params.embedding, spk_idx)
    return _finish(params, cfg, emb_map, hidden, queries, feat, mix_ri, probs)


def separate_dense(params: Separator, feat: torch.Tensor, cfg: Config,
                   channel_gate: torch.Tensor,
                   mix_ri: Optional[torch.Tensor] = None) -> SeparatorOutput:
    """All-speaker channel layout (main_run.py:473-489): channel_gate (B,S)
    in {0,1}; the masks of gated-off speakers are zeroed, as the reference
    multiplies by the expanded top_k_mask (:488-489). The plain mask head
    (the embedding grid), as in JAX."""
    emb_map, hidden = apply_encoder(params.encoder, feat, cfg)
    probs = torch.zeros((feat.shape[0], cfg.num_speakers), dtype=feat.dtype,
                        device=feat.device)
    queries = apply_embedding_gated(params.embedding, channel_gate)
    out = _finish(params, cfg, emb_map, hidden, queries, feat, mix_ri, probs)
    gate = channel_gate[..., None, None]
    if cfg.is_complex_mask:
        gate = gate[..., None]
    return out._replace(masks=out.masks * gate.to(out.masks.dtype),
                        pred=out.pred * gate.to(out.pred.dtype))


def recursive_separate(params: Separator, feat: torch.Tensor, cfg: Config,
                       allowed: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TDAA's recursive extraction. Peel one speaker per step: classify the
    residual, take the most probable speaker not yet extracted, mask it
    out, and feed `(1-mask) * residual` back in
    (main_run_multi_selfSS_recu.py:341-400), for cfg.recursive_max_steps
    steps. Each step runs the encoder, the classifier, ADDJUST under
    cfg.is_self_tune and the plain mask head (not the fused one), as in
    JAX.

    `allowed` ((B, S) bool, optional) restricts every step's choice to a
    per-sample candidate roster, composed with the loop's own
    already-extracted exclusion.

    Returns (extracted (B, steps, T, F), speaker indices (B, steps)).
    """
    if cfg.is_complex_mask:
        raise ValueError(
            "recursive extraction operates on magnitude residuals; the "
            "reference's recursive scripts are magnitude-only too "
            "(main_run_multi_selfSS_recu.py:398-400). Use top-k mode for "
            "cRM models.")
    if cfg.log_spectral:
        raise ValueError(
            "recursive extraction peels (1-mask)*residual in the LINEAR "
            "magnitude domain; log-spectral features cannot be peeled "
            "(the reference's recursive scripts are linear-only)")
    residual = feat
    seen = torch.zeros((feat.shape[0], cfg.num_speakers), dtype=torch.bool,
                       device=feat.device)
    extracted, spks = [], []
    for _ in range(cfg.recursive_max_steps):
        emb_map, hidden = apply_encoder(params.encoder, residual, cfg)
        probs = apply_classifier(params.classifier, residual, cfg)
        blocked = seen if allowed is None else seen | ~allowed.to(torch.bool)
        spk = probs.masked_fill(blocked, float("-inf")).argmax(dim=-1)
        queries = apply_embedding(params.embedding, spk[:, None])
        if cfg.is_self_tune:
            queries = apply_adjust(params.adjust, hidden, queries)
        mask = apply_mask_head(params.mask_head, emb_map, queries, cfg)[:, 0]
        extracted.append(mask * residual)
        residual = (1.0 - mask) * residual
        seen = seen | torch.nn.functional.one_hot(
            spk, cfg.num_speakers).to(torch.bool)
        spks.append(spk)
    return torch.stack(extracted, dim=1), torch.stack(spks, dim=1)
