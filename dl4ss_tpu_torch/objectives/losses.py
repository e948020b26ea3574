"""Training objectives (the port of `dl4ss_tpu/objectives/losses.py`).

The reference's loss surface, in one place:
  * mask MSE vs per-speaker clean magnitudes (Torch_multi/main_run.py:493-506)
  * the (disabled by default) 0.5 * sum-to-one channel loss (:508-513)
  * complex MSE = MSE(real) + MSE(imag) for the cRM path
    (TDAA_beta/main_run_sstune_cRM_EvalVer.py:566-568)
  * MultiLabelSoftMarginLoss for the classifier
    (Torch_multi/test_multi_labels_speech.py:397)
  * the MSE-GAN discriminator/generator losses
    (TDAA_beta/main_run_sstune_dis.py:615-632, 683-700)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def mask_mse_loss(pred_specs: torch.Tensor, target_specs: torch.Tensor,
                  channel_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """MSE over (B, K, T, F) masked spectrograms.

    With `channel_weights` (B, K) the mean still normalizes over ALL
    elements — the reference's all-channel MSE where inactive channels
    contribute exact zeros (main_run.py:488-506).
    """
    se = (pred_specs - target_specs) ** 2
    if channel_weights is not None:
        se = se * channel_weights[..., None, None].to(se.dtype)
    return se.mean()


def sum_to_one_loss(pred_specs: torch.Tensor) -> torch.Tensor:
    """MSE(sum_k pred, 1) — channels should tile the mixture (:508-513)."""
    return ((pred_specs.sum(dim=1) - 1.0) ** 2).mean()


def complex_mse_loss(pred_ri: torch.Tensor, target_ri: torch.Tensor,
                     channel_weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """MSE(real) + MSE(imag) on (..., 2)-packed complex spectrograms."""
    se = (pred_ri - target_ri) ** 2
    if channel_weights is not None:
        se = se * channel_weights[..., None, None, None].to(se.dtype)
    return se[..., 0].mean() + se[..., 1].mean()


def multilabel_softmargin_loss(logits: torch.Tensor, targets: torch.Tensor
                               ) -> torch.Tensor:
    """torch.nn.MultiLabelSoftMarginLoss: mean over classes of
    -[y*log sigmoid(x) + (1-y)*log sigmoid(-x)], then mean over batch."""
    per_class = -(targets * F.logsigmoid(logits)
                  + (1.0 - targets) * F.logsigmoid(-logits))
    return per_class.mean(dim=-1).mean()


def gan_d_loss(score_real: torch.Tensor, score_fake: torch.Tensor
               ) -> torch.Tensor:
    """loss_dis = MSE(D(real), 1) + MSE(D(fake), 0)."""
    return ((score_real - 1.0) ** 2).mean() + (score_fake ** 2).mean()


def gan_g_loss(score_fake: torch.Tensor) -> torch.Tensor:
    """Generator adversarial term: MSE(D(fake), 1)."""
    return ((score_fake - 1.0) ** 2).mean()
