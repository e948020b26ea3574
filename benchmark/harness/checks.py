"""The comparison's arithmetic: a number beside its limit, relative
errors, the leaves' gaps of norms and norms of differences, and the
precision the reference computes in."""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, Iterable, NamedTuple, Set

import torch


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 (`on`) or in full float32."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| in float64."""
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def moved_leaves(ref_grad_norms: Dict[str, float],
                 rule: float = 1e-3) -> Set[str]:
    """The leaves that the reference's gradient moves: those whose norm
    is at least `rule` times the median leaf's. The others (such as a
    classifier the loss never reaches) move under Adam by round-off
    alone, or not at all."""
    med = statistics.median(ref_grad_norms.values())
    return {n for n, v in ref_grad_norms.items() if v >= rule * med}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Iterable[str]) -> Dict[str, float]:
    """Per leaf, |prog - ref| / max(ref, the median leaf's ref), where
    prog and ref are the leaves' norms: the gap between two norms, not
    the norm of the difference."""
    leaves = list(leaves)
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: Iterable[str]) -> Dict[str, float]:
    """Per leaf, ||prog - ref|| / max(||ref||, the median leaf's ||ref||):
    the norm of the difference, which rounding that cancels in a norm
    does not hide."""
    leaves = list(leaves)
    ref_n = norms({n: ref[n] for n in leaves})
    med = statistics.median(ref_n.values())
    diff = norms({n: prog[n] - ref[n] for n in leaves})
    return {n: diff[n] / max(ref_n[n], med) for n in leaves}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}
