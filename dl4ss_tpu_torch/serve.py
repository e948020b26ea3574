"""The serving programs: mixture waveforms -> separated waveforms.

The port of the repo's serving pipeline (bench.py:107-119, and its B=1 form
at :159-166): wav -> STFT features (K1) -> `separate` (encoder with K2 per
layer, mask head K3) -> masked iSTFT (K4). The speakers are given, or the
classifier picks its top-k (its BiLSTM on K7 per layer). A cRM model
(cfg.is_complex_mask) predicts complex spectra, which the plain iSTFT
resynthesises, as in JAX. The recursive program peels one
classifier-chosen speaker per step and resynthesises each peeled spectrum
with the mixture phase. With the config's kernel flags off, the same
programs run the plain PyTorch path. Each marks its phases for the
profiler (`utils.profiling.span`): `features`, `separate`, `resynthesis`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.models.separator import (Separator, recursive_separate,
                                              separate)
from dl4ss_tpu_torch.objectives.select import top_k_indices
from dl4ss_tpu_torch.ops.crm import unpack_ri
from dl4ss_tpu_torch.ops.stft import (istft_cfg, masked_resynthesis,
                                      spectral_feature_cfg)
from dl4ss_tpu_torch.utils.profiling import span


def _features(model: Separator, wav: torch.Tensor, cfg: Config):
    """wav (B, N) -> (feat (B, T, F) in the model's dtype, re, im f32)."""
    with span("features"):
        feat_dtype = model.encoder.proj.w.dtype
        if cfg.use_pallas_stft and not cfg.log_spectral:
            from dl4ss_tpu_torch.ops.stft_kernels import stft_features
            return stft_features(
                wav, cfg.frame_length, cfg.frame_shift, window=cfg.window,
                center=cfg.center, feat_dtype=feat_dtype)
        feat, spec = spectral_feature_cfg(wav, cfg)
        return feat.to(feat_dtype), spec.real, spec.imag


def _separate(model, wav, cfg, spk_idx, length):
    feat, re, im = _features(model, wav, cfg)
    with span("separate"):
        mix_ri = (torch.stack([re, im], dim=-1)
                  if cfg.log_spectral or cfg.is_complex_mask else None)
        out = separate(model, feat, cfg, spk_idx=spk_idx, mix_ri=mix_ri)
    with span("resynthesis"):
        if cfg.is_complex_mask:
            return istft_cfg(unpack_ri(out.pred.float()), cfg,
                             length=length), out
        return masked_resynthesis(re, im, out.masks, cfg, length=length), out


def separate_waveforms(model: Separator, wav: torch.Tensor, cfg: Config,
                       spk_idx: Optional[torch.Tensor] = None,
                       length: Optional[int] = None) -> torch.Tensor:
    """wav (B, N) f32 on the model's device, spk_idx (B, K) int ->
    (B, K, length) f32 waveforms, one channel per requested speaker; with
    no `spk_idx`, one per speaker of the classifier's top-k, most probable
    first.

    Phasor-free: the masks multiply the complex mixture spectrum directly,
    istft(mask (.) X) == istft(mask . |X| . e^{j angle X})."""
    with torch.inference_mode():
        return _separate(model, wav, cfg, spk_idx, length)[0]


def select_and_separate(model: Separator, wav: torch.Tensor, cfg: Config,
                        length: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`separate_waveforms` with classifier-selected speakers, returning
    the selection too: ((B, K, length) waveforms, (B, K) speaker indices,
    most probable first)."""
    with torch.inference_mode():
        wavs, out = _separate(model, wav, cfg, None, length)
        return wavs, top_k_indices(out.probs, cfg.top_k)[0]


def recursive_waveforms(model: Separator, wav: torch.Tensor, cfg: Config,
                        length: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive extraction: wav (B, N) -> ((B, steps, length) waveforms,
    (B, steps) speaker indices), steps = cfg.recursive_max_steps. The peel
    steps resynthesise from masked RESIDUALS, not the original spectrum, so
    each peeled magnitude takes the mixture's phasor and goes through the
    plain iSTFT, as in JAX."""
    with torch.inference_mode():
        feat, re, im = _features(model, wav, cfg)
        with span("separate"):
            extracted, spks = recursive_separate(model, feat, cfg)
        with span("resynthesis"):
            mix = torch.complex(re, im)
            phasor = mix / torch.clamp(mix.abs(), min=1e-8)
            wavs = istft_cfg(extracted.float() * phasor[:, None], cfg,
                             length=length)
        return wavs, spks
