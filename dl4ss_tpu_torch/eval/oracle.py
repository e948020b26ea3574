"""Oracle-mask SI-SDR bounds, the yardstick for learned masks (the port of
`dl4ss_tpu/eval/oracle.py`).

A learned magnitude mask cannot beat the best mask computed from the TRUE
sources, so the oracle score of the eval data is the ceiling to report
beside the learned one:

  * IAM (ideal amplitude mask), |S_k| / |X| clipped to [0, 1]: the exact
    ceiling of the sigmoid-bounded magnitude masks (ATTENTION's sigmoid
    head, Torch_multi/main_run.py:201-210);
  * IRM (ideal ratio mask), |S_k| / sum_j |S_j|.

Both resynthesise with the MIXTURE phase (pred = mask .* |X| .* e^{j arg X},
main_run.py:48-51), through the plain STFT and iSTFT (`stft_cfg` /
`istft_cfg`), as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.eval.sisdr import si_sdr
from dl4ss_tpu_torch.ops.stft import istft_cfg, stft_cfg


def oracle_mask_sisdr(mix_wav: torch.Tensor, source_wavs: torch.Tensor,
                      cfg: Config, kind: str = "iam",
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N) mixture + (B, K, N) sources -> the mean oracle SI-SDR of each
    mixture over its live channels (B,). Channel k's mask is built from
    source k, so no permutation search."""
    if kind not in ("iam", "irm"):
        raise ValueError(f"unknown oracle kind {kind!r}")
    with torch.no_grad():
        mix_spec = stft_cfg(mix_wav, cfg)                  # (B, T, F)
        src_mag = stft_cfg(source_wavs, cfg).abs()         # (B, K, T, F)
        mix_mag = mix_spec.abs()
        if kind == "iam":
            mask = (src_mag / mix_mag[:, None].clamp(min=1e-8)).clamp(0, 1)
        else:
            mask = src_mag / src_mag.sum(dim=1, keepdim=True).clamp(min=1e-8)
        phasor = mix_spec / mix_mag.clamp(min=1e-8)
        pred = mask * mix_mag[:, None] * phasor[:, None]
        wavs = istft_cfg(pred, cfg, length=mix_wav.shape[-1])
        scores = si_sdr(wavs, source_wavs)                  # (B, K)
        if live is None:
            return scores.mean(dim=-1)
        w = live.to(scores.dtype)
        return (scores * w).sum(-1) / w.sum(-1).clamp(min=1.0)
