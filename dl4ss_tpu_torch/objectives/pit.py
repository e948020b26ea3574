"""Utterance-level permutation-invariant training (the port of
`dl4ss_tpu/objectives/pit.py`).

All K! permutations are enumerated (K <= 4 in every reference config); the
per-(pred, target) pair losses are computed once as a (B, K, K) matrix and
each permutation's score is a gather-mean over it.
"""

from __future__ import annotations

import itertools
from typing import Callable, Tuple

import torch


def _pair_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, K, ...) x (B, K, ...) -> (B, K, K) mean-squared-error matrix
    with pairs[b, i, j] = MSE(pred[b, i], target[b, j])."""
    dims = tuple(range(3, pred.dim() + 1))
    diff = pred[:, :, None] - target[:, None, :]
    return (diff ** 2).mean(dim=dims)


def pit_loss(pred: torch.Tensor, target: torch.Tensor,
             pair_loss: Callable = _pair_mse
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scalar loss, best permutation indices (B, K)).

    loss = mean over batch of min_perm mean_k pair_loss(pred_k, target_perm(k)).
    """
    k = pred.shape[1]
    perms = torch.tensor(list(itertools.permutations(range(k))),
                         device=pred.device)                    # (P, K)
    pairs = pair_loss(pred, target)                             # (B, K, K)
    gathered = pairs[:, torch.arange(k, device=pred.device)[None, :], perms]
    scores = gathered.mean(dim=-1)                              # (B, P)
    best, idx = scores.min(dim=-1)
    return best.mean(), perms[idx]


def pit_permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Apply a per-sample channel permutation: x (B, K, ...), perm (B, K)."""
    idx = perm.reshape(perm.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)
