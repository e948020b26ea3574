"""The serving program: mixture waveforms -> separated waveforms.

The port of the repo's serving pipeline (bench.py:107-119, and its B=1 form
at :159-166): wav -> STFT features (K1) -> `separate` (encoder with K2 per
layer, mask head K3) -> masked iSTFT (K4). Speakers are given. With the
config's kernel flags off, the same program runs the plain PyTorch path.
"""

from __future__ import annotations

from typing import Optional

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.models.separator import Separator, separate
from dl4ss_tpu_torch.ops.stft import masked_resynthesis, spectral_feature_cfg


def separate_waveforms(model: Separator, wav: torch.Tensor, cfg: Config,
                       spk_idx: torch.Tensor, length: Optional[int] = None
                       ) -> torch.Tensor:
    """wav (B, N) f32 on the model's device, spk_idx (B, K) int ->
    (B, K, length) f32 waveforms, one channel per requested speaker.

    Phasor-free: the masks multiply the complex mixture spectrum directly,
    istft(mask (.) X) == istft(mask . |X| . e^{j angle X})."""
    feat_dtype = model.encoder.proj.w.dtype
    with torch.inference_mode():
        if cfg.use_pallas_stft and not cfg.log_spectral:
            from dl4ss_tpu_torch.ops.stft_kernels import stft_features
            feat, re, im = stft_features(
                wav, cfg.frame_length, cfg.frame_shift, window=cfg.window,
                center=cfg.center, feat_dtype=feat_dtype)
        else:
            feat, spec = spectral_feature_cfg(wav, cfg)
            feat, re, im = feat.to(feat_dtype), spec.real, spec.imag
        mix_ri = torch.stack([re, im], dim=-1) if cfg.log_spectral else None
        out = separate(model, feat, cfg, spk_idx=spk_idx, mix_ri=mix_ri)
        return masked_resynthesis(re, im, out.masks, cfg, length=length)
