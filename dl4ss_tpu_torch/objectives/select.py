"""Speaker-channel selection: thresholded top-k, candidate rosters and
cosine dedup (the port of `dl4ss_tpu/objectives/select.py`).

  * top_k_mask (Torch_multi/main_run.py:340-355): keep a speaker iff its
    classifier probability is among the row's top_k AND exceeds alpha.
  * candidate_pools / candidate_restricted_select: the multi-speech test
    protocol's per-sample rosters (predata_multiSpeechTest.py:89-115).
  * select_the_final "quchong" dedup
    (Torch_multi/main_run_multi_selfSS_quchong.py:398-445): walk candidates
    by descending probability, keep one iff its embedding's cosine distance
    to every already-kept embedding >= alpha, stop at top_k; 2-mix fallback
    appends the embedding farthest from the top-1 pick.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each entry in its row by descending score (0 = largest;
    ties go to the lower index, as a stable argsort of the negation)."""
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def top_k_mask(probs: torch.Tensor, alpha: float, top_k: int) -> torch.Tensor:
    """(B, S) probabilities -> (B, S) 0/1 channel gate."""
    keep = (_ranks(probs) < top_k) & (probs > alpha)
    return keep.to(probs.dtype)


def top_k_indices(probs: torch.Tensor, top_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) -> (indices (B, K) sorted by prob desc, their probs)."""
    vals, idx = torch.topk(probs, top_k, dim=-1)
    return idx, vals


def candidate_pools(generator: torch.Generator, spk_idx: torch.Tensor,
                    live: torch.Tensor, n_candidates: int,
                    num_speakers: int) -> torch.Tensor:
    """Per-sample candidate rosters for the multi-speech test protocol
    (`aim_pro`): each sample knows a short list of POSSIBLE speakers a
    priori — the true mixed speakers plus random distractors up to
    `n_candidates`. Returns a (B, S) boolean membership mask.

    Distractors are drawn without replacement from the non-true vocabulary
    by a per-row random ranking, on the CPU generator (one seed, the same
    rosters on every device)."""
    b = spk_idx.shape[0]
    dev = spk_idx.device
    member = torch.zeros((b, num_speakers), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None].expand_as(spk_idx)
    live = live.to(torch.bool)
    member[rows[live], spk_idx[live]] = True
    scores = torch.rand((b, num_speakers), generator=generator).to(dev)
    scores = scores.masked_fill(member, float("-inf"))   # never re-draw true
    n_true = member.sum(dim=-1, keepdim=True)
    want = (n_candidates - n_true).clamp(min=0)
    return member | (_ranks(scores) < want)


def candidate_restricted_select(probs: torch.Tensor,
                                candidates: torch.Tensor,
                                top_k: int) -> torch.Tensor:
    """Top-k speaker selection restricted to a per-sample candidate pool.
    probs (B, S); candidates (B, S) boolean membership -> indices (B, K)."""
    masked = torch.where(candidates.to(torch.bool), probs,
                         torch.full_like(probs, -1.0))
    return torch.topk(masked, top_k, dim=-1).indices


def cosine_dedup_select(probs: torch.Tensor, embeddings: torch.Tensor,
                        alpha: float = 0.15, top_k: int = 2,
                        two_mix_fallback: bool = True) -> torch.Tensor:
    """Greedy diversity-aware speaker selection. Returns indices (B, K).

    probs (B, S); embeddings (S, Q), the speaker-embedding table rows.
    Walks each row's S candidates in probability order (a host loop: S is
    the speaker vocabulary, and this runs once per evaluation batch). Rows
    that keep fewer than top_k candidates are filled in visit order with
    the first candidates not kept, as the reference's static-shape gather
    does."""
    b, s = probs.shape
    norm = embeddings / torch.linalg.vector_norm(
        embeddings, dim=-1, keepdim=True).clamp(min=1e-12)
    cos_dist = (1.0 - norm @ norm.T).cpu()               # (S, S)
    order = torch.argsort(probs, dim=-1, descending=True, stable=True).cpu()
    picked = torch.empty((b, top_k), dtype=torch.long)
    for row in range(b):
        kept, skipped = [], []
        for cand in order[row].tolist():
            conflict = any(bool(cos_dist[cand, k] < alpha) for k in kept)
            if not conflict and len(kept) < top_k:
                kept.append(cand)
            else:
                skipped.append(cand)
        n_kept = len(kept)
        chosen = (kept + skipped)[:top_k]
        if two_mix_fallback and top_k == 2 and n_kept < 2:
            top1 = int(order[row, 0])
            chosen = [top1, int(torch.argmax(cos_dist[top1]))]
        picked[row] = torch.tensor(chosen)
    return picked.to(probs.device)
