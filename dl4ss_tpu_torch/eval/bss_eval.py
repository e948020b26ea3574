"""BSS-Eval (SDR / SIR / SAR) with permutation resolution (the port of
`dl4ss_tpu/eval/bss_eval.py`).

The reference scores with two opaque implementations: a vendored-but-missing
`separation.bss_eval_sources` (Torch_multi/bss_test.py:5, mir_eval-style,
512-tap projections, permutation by SIR) and MATLAB BSS-Eval 2.0
(Cocktail/.../BSS_EVAL.m). Here, as in the JAX package:

  * `bss_eval_sources_numpy`: the BSS Eval v3 `sources` variant (Vincent,
    Gribonval, Fevotte 2006) in float64 from explicit delay matrices and
    least squares, exact by construction: the oracle the tests and the
    card's check hold the batched version to;
  * `bss_eval_sources`: batched in torch on the inputs' device. The Gram
    matrix of the delayed sources and every cross-correlation come from
    overlap-save FFTs (`ops.xcorr`), one (K*flen)^2 solve and K (flen)^2
    solves a mixture (`torch.linalg.solve`, in the inputs' dtype; the
    entry points run f32 with TF32 off), the projections as FIR filters by
    FFT; the permutation is the one with the largest mean SIR, as mir_eval
    chooses;
  * the BSS-Eval 2.0 gain decomposition (`bss_decomp_gain_numpy` /
    `bss_crit_numpy` oracles, batched `bss_eval_gain`, `gain_nsdr`).

NSDR(pred) = SDR(pred) - SDR(mixture-as-prediction)
(Cocktail/.../BSS_EVAL.m:16-21).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from dl4ss_tpu_torch.ops.xcorr import ola_conv, xcorr


class BssResult(NamedTuple):
    sdr: torch.Tensor   # (K,) or (B, K)
    sir: torch.Tensor
    sar: torch.Tensor
    perm: torch.Tensor  # estimate j is scored against source perm[j]


# ---------------------------------------------------------------------------
# numpy ground truth (test oracle)
# ---------------------------------------------------------------------------


def _delay_matrix(sig: np.ndarray, flen: int) -> np.ndarray:
    """(N,) -> (N + flen - 1, flen): column p is sig delayed by p."""
    n = len(sig)
    out = np.zeros((n + flen - 1, flen), sig.dtype)
    for p in range(flen):
        out[p:p + n, p] = sig
    return out


def bss_eval_sources_numpy(ref: np.ndarray, est: np.ndarray,
                           flen: int = 512, permute: bool = True):
    """ref, est: (K, N) float64. Returns (sdr, sir, sar, perm) numpy arrays."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    k, n = ref.shape
    delays = [_delay_matrix(ref[i], flen) for i in range(k)]     # (L, flen)
    all_mat = np.concatenate(delays, axis=1)                     # (L, K*flen)
    sdr = np.zeros((k, k))
    sir = np.zeros((k, k))
    sar = np.zeros((k, k))
    for j in range(k):
        e = np.zeros(n + flen - 1)
        e[:n] = est[j]
        # the all-sources projection depends only on the estimate j —
        # solve it once per j, not once per (j, i) pair
        c_all, *_ = np.linalg.lstsq(all_mat, e, rcond=None)
        p_all = all_mat @ c_all
        e_artif = e - p_all
        for i in range(k):
            c_true, *_ = np.linalg.lstsq(delays[i], e, rcond=None)
            s_true = delays[i] @ c_true
            e_interf = p_all - s_true
            sdr[j, i] = 10 * np.log10(
                np.sum(s_true ** 2) / np.sum((e_interf + e_artif) ** 2))
            sir[j, i] = 10 * np.log10(
                np.sum(s_true ** 2) / np.sum(e_interf ** 2))
            sar[j, i] = 10 * np.log10(
                np.sum((s_true + e_interf) ** 2) / np.sum(e_artif ** 2))
    if not permute:
        d = np.arange(k)
        return sdr[d, d], sir[d, d], sar[d, d], d
    best, best_sir = None, -np.inf
    for perm in itertools.permutations(range(k)):
        p = np.array(perm)
        m = np.mean(sir[np.arange(k), p])
        if m > best_sir:
            best, best_sir = p, m
    d = np.arange(k)
    return sdr[d, best], sir[d, best], sar[d, best], best



# ---------------------------------------------------------------------------
# batched torch implementation
# ---------------------------------------------------------------------------


def _db(num: torch.Tensor, den: torch.Tensor, eps: float) -> torch.Tensor:
    return 10.0 * torch.log10(num.clamp(min=eps) / den.clamp(min=eps))


def bss_eval_sources(ref: torch.Tensor, est: torch.Tensor, flen: int = 512,
                     permute: bool = True, ridge: float = 1e-8
                     ) -> BssResult:
    """ref, est: (K, N) or (B, K, N) tensors, computed in their dtype on
    their device. The least-squares projections solve the (K*flen)^2 Gram
    system of the delayed sources and the (flen)^2 diagonal blocks, each
    with a `ridge` on the diagonal (tiny against unit-peak signals), as the
    JAX package does."""
    if ref.dim() == 2:
        return BssResult(*(x[0] for x in bss_eval_sources(
            ref[None], est[None], flen, permute, ridge)))
    b, k, n = ref.shape
    dev, dtype = ref.device, ref.dtype
    est = est.to(dtype)
    # Gram of the delayed-source family from the lag correlations:
    # G[(a,p),(c,q)] = sum_u ref[a,u] ref[c,u+p-q] = corr[c, a, p-q]
    corr = xcorr(ref, ref, -(flen - 1), flen - 1)        # (B, Kc, Ka, 2F-1)
    lag = (torch.arange(flen, device=dev)[:, None]
           - torch.arange(flen, device=dev)[None, :] + flen - 1)
    corr_t = corr.transpose(1, 2)                        # (B, Ka, Kc, 2F-1)
    gram = corr_t[..., lag]                              # (B, Ka, Kc, F, F)
    gram = gram.permute(0, 1, 3, 2, 4).reshape(b, k * flen, k * flen)
    # D[j, (a,p)] = sum_u ref[a,u] est[j,u+p]
    d = xcorr(ref, est, 0, flen - 1)                     # (B, Kest, Ka, F)
    eye = torch.eye(k * flen, device=dev, dtype=dtype)
    coef_all = torch.linalg.solve(gram + ridge * eye,
                                  d.reshape(b, k, k * flen).transpose(1, 2))
    # proj_all[j, t] = sum_{a,p} coef[(a,p), j] ref[a, t-p]: each source
    # FIR-filtered by its taps and summed
    kern_all = coef_all.transpose(1, 2).reshape(b, k, k, flen)
    proj_all = ola_conv(ref, kern_all, sum_channels=True)   # (B, Kest, L)
    # per-source projections from the (flen, flen) diagonal blocks
    diag = torch.arange(k, device=dev)
    gii = corr_t[:, diag, diag][..., lag]                # (B, K, F, F)
    eye_f = torch.eye(flen, device=dev, dtype=dtype)
    coef_single = torch.linalg.solve(gii + ridge * eye_f,
                                     d.permute(0, 2, 3, 1))  # (B, Ks, F, Ke)
    kern_s = coef_single.permute(0, 3, 1, 2)             # (B, Ke, Ks, F)
    s_true = ola_conv(ref, kern_s, sum_channels=False)   # (B, Ke, Ks, L)
    est_pad = torch.nn.functional.pad(est, (0, flen - 1))
    e_interf = proj_all[:, :, None] - s_true
    e_artif = (est_pad - proj_all)[:, :, None]
    p_true = (s_true ** 2).sum(-1)
    sdr = _db(p_true, ((e_interf + e_artif) ** 2).sum(-1), 1e-12)
    sir = _db(p_true, (e_interf ** 2).sum(-1), 1e-12)
    sar = _db(((s_true + e_interf) ** 2).sum(-1), (e_artif ** 2).sum(-1),
              1e-12)                                     # (B, Kest, Ksrc)
    j = torch.arange(k, device=dev)
    if not permute:
        perm = j.expand(b, k)
    else:
        perms = torch.tensor(list(itertools.permutations(range(k))),
                             device=dev)                 # (P, K)
        mean_sir = sir[:, j[None, :], perms].mean(-1)    # (B, P)
        perm = perms[mean_sir.argmax(-1)]                # (B, K)
    rows = torch.arange(b, device=dev)[:, None]
    pick = (rows, j[None, :], perm)
    return BssResult(sdr[pick], sir[pick], sar[pick], perm)


def nsdr(sdr_pred: torch.Tensor, sdr_mix: torch.Tensor) -> torch.Tensor:
    """NSDR = SDR(pred) - SDR(mix-as-pred) (BSS_EVAL.m:16-21)."""
    return sdr_pred - sdr_mix


# ---------------------------------------------------------------------------
# BSS-Eval 2.0 gain decomposition (bss_decomp_gain + bss_crit)
# ---------------------------------------------------------------------------
#
# The Keras stacks score with BSS-Eval 2.0: the allowed distortion of the
# target is one time-invariant scalar gain, and the interference space is
# the span of the sources themselves (no 512-tap filters), MATLAB
# `bss_decomp_gain(se, index, S)` + `bss_crit`
# (Cocktail/software/DL4SS_Keras/BSS_EVAL.m:8-21). The NSDR baseline scores
# the mixture against the TARGET ALONE (BSS_EVAL.m:14-16).


def bss_decomp_gain_numpy(est: np.ndarray, index: int, sources: np.ndarray):
    """Transparent oracle of MATLAB bss_decomp_gain (0-based `index`).

    est (N,), sources (K, N) float64 ->
      s_target = <est, s_i>/||s_i||^2 * s_i        (scalar-gain projection)
      e_interf = P_{span(sources)} est - s_target  (time-invariant gains)
      e_artif  = est - P_{span(sources)} est
    """
    est = np.asarray(est, np.float64)
    s = np.asarray(sources, np.float64)
    si = s[index]
    s_target = (est @ si) / (si @ si) * si
    coef, *_ = np.linalg.lstsq(s.T, est, rcond=None)
    p_all = s.T @ coef
    return s_target, p_all - s_target, est - p_all


def bss_crit_numpy(s_target, e_interf, e_artif):
    """bss_crit: SDR / SIR / SAR from a gain decomposition (BSS_EVAL.m:10-13).
    With a single source e_interf is exactly 0 and SIR is +inf."""
    pt = np.sum(np.asarray(s_target) ** 2)
    pi = np.sum(np.asarray(e_interf) ** 2)
    pa = np.sum(np.asarray(e_artif) ** 2)
    with np.errstate(divide="ignore"):
        sdr = 10 * np.log10(pt / (pi + pa))
        sir = 10 * np.log10(pt / pi) if pi > 0 else np.inf
        sar = 10 * np.log10(np.sum((np.asarray(s_target)
                                    + np.asarray(e_interf)) ** 2) / pa)
    return sdr, sir, sar



def bss_eval_gain(ref: torch.Tensor, est: torch.Tensor,
                  target_index: int = 0, ridge: float = 1e-10) -> BssResult:
    """Batched BSS-Eval 2.0 gain decomposition.

    ref (B, K, N) sources (dead, all-zero rows are tolerated through the
    tiny ridge: their gain solves to 0), est (B, N) one estimate a mixture,
    `target_index` the target's channel. Returns (B,) sdr / sir / sar and
    the constant target index as perm (designated channels, nothing to
    permute, BSS_EVAL.m:10-16)."""
    est = est.to(ref.dtype)
    b, k, _ = ref.shape
    si = ref[:, target_index]                                # (B, N)
    num = (est * si).sum(-1)
    den = (si * si).sum(-1).clamp(min=1e-20)
    s_target = (num / den)[:, None] * si
    gram = ref @ ref.transpose(1, 2)                         # (B, K, K)
    rhs = (ref @ est[..., None])                             # (B, K, 1)
    eye = torch.eye(k, device=ref.device, dtype=ref.dtype)
    coef = torch.linalg.solve(gram + ridge * eye, rhs)       # (B, K, 1)
    p_all = (coef * ref).sum(1)                              # (B, N)
    e_interf = p_all - s_target
    e_artif = est - p_all
    pt = (s_target ** 2).sum(-1)
    pi = (e_interf ** 2).sum(-1)
    pa = (e_artif ** 2).sum(-1)
    sdr = _db(pt, pi + pa, 1e-20)
    sir = _db(pt, pi, 1e-20)
    sar = _db(((s_target + e_interf) ** 2).sum(-1), pa, 1e-20)
    return BssResult(sdr, sir, sar,
                     torch.full((b,), target_index, dtype=torch.long,
                                device=ref.device))


def gain_nsdr(pred: torch.Tensor, mix: torch.Tensor, sources: torch.Tensor,
              live: Optional[torch.Tensor] = None, target_index: int = 0):
    """The Cocktail metric (BSS_EVAL.m:8-21): SDR / SIR / SAR of `pred`
    against ALL sources, and NSDR = SDR - SDR(mix against the TARGET
    ALONE). pred / mix (B, N), sources (B, K, N), channel 0 the target
    (first speaker is the target); `live` (B, K) zeroes dead padded
    channels before the solve. Returns (BssResult, nsdr (B,))."""
    if live is not None:
        sources = sources * live[..., None].to(sources.dtype)
    res = bss_eval_gain(sources, pred, target_index=target_index)
    base = bss_eval_gain(sources[:, target_index:target_index + 1], mix,
                         target_index=0)
    return res, res.sdr - base.sdr
