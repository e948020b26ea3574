"""Scale-invariant SDR and plain SDR (the port of `dl4ss_tpu/eval/sisdr.py`).

SI-SDR (Le Roux et al. 2019) is the in-loop metric the trainer scores each
epoch with; it runs on the model's device.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch


def si_sdr(est: torch.Tensor, ref: torch.Tensor, zero_mean: bool = True,
           eps: float = 1e-8) -> torch.Tensor:
    """SI-SDR in dB over the last axis; leading axes broadcast."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        ref = ref - ref.mean(dim=-1, keepdim=True)
    dot = (est * ref).sum(dim=-1, keepdim=True)
    energy = (ref * ref).sum(dim=-1, keepdim=True)
    target = (dot / torch.clamp(energy, min=eps)) * ref
    noise = est - target
    ratio = ((target ** 2).sum(dim=-1)
             / torch.clamp((noise ** 2).sum(dim=-1), min=eps))
    return 10.0 * torch.log10(torch.clamp(ratio, min=eps))


def sdr_simple(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8
               ) -> torch.Tensor:
    """Plain (scale-variant) SNR-style SDR in dB."""
    ratio = ((ref ** 2).sum(dim=-1)
             / torch.clamp(((est - ref) ** 2).sum(dim=-1), min=eps))
    return 10.0 * torch.log10(torch.clamp(ratio, min=eps))


def si_sdr_pit(est: torch.Tensor, ref: torch.Tensor,
               live: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation-resolved SI-SDR: est/ref (B, K, N).

    Returns (per-sample mean SI-SDR over channels (B,), best perms (B, K)).
    `live` (B, K) masks dead reference channels (zero-gain speakers of
    variable-k mixtures) out of the mean.
    """
    k = est.shape[1]
    perms = torch.tensor(list(itertools.permutations(range(k))),
                         device=est.device)                    # (P, K)
    pair = si_sdr(est[:, :, None], ref[:, None, :, :])         # (B, K, K)
    gathered = pair[:, torch.arange(k, device=est.device)[None, :], perms]
    if live is not None:
        # weight each (est i -> ref perm[i]) pair by that ref's liveness
        w = live.to(gathered.dtype)[:, perms]                   # (B, P, K)
        scores = ((gathered * w).sum(dim=-1)
                  / torch.clamp(w.sum(dim=-1), min=1.0))
    else:
        scores = gathered.mean(dim=-1)                          # (B, P)
    best, idx = scores.max(dim=-1)
    return best, perms[idx]
