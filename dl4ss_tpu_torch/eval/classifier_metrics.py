"""Multi-label classifier metrics (the port's copy of
`dl4ss_tpu/eval/classifier_metrics.py`: numpy only).

Rebuilds the reference's evaluation trio: element/sample accuracy and top-k
recall (`count_multi_acc`, Torch_multi/test_multi_labels_speech.py:300-351),
and the sklearn hamming-loss / micro-macro precision-recall-F1 report
(test_multi_labels_speech_metrics.py:305-315) — implemented in numpy and
validated against sklearn in tests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def multilabel_accuracy(probs: np.ndarray, targets: np.ndarray,
                        alpha: float = 0.5) -> Dict[str, float]:
    """Element accuracy, exact-set sample accuracy, hamming loss."""
    pred = (np.asarray(probs) > alpha).astype(np.int32)
    tgt = np.asarray(targets).astype(np.int32)
    element = float(np.mean(pred == tgt))
    sample = float(np.mean(np.all(pred == tgt, axis=-1)))
    hamming = float(np.mean(pred != tgt))
    return {"element_acc": element, "sample_acc": sample,
            "hamming_loss": hamming}


def topk_recall(probs: np.ndarray, targets: np.ndarray, k: int = 3) -> float:
    """Fraction of true speakers recovered in each row's top-k predictions
    (the reference's 'top3 recall 80%' metric)."""
    probs = np.asarray(probs)
    tgt = np.asarray(targets) > 0
    order = np.argsort(-probs, axis=-1)[:, :k]
    hits, total = 0, 0
    for r in range(probs.shape[0]):
        true_set = set(np.nonzero(tgt[r])[0].tolist())
        total += len(true_set)
        hits += len(true_set & set(order[r].tolist()))
    return hits / max(total, 1)


def _prf(tp: float, fp: float, fn: float):
    p = tp / (tp + fp) if tp + fp > 0 else 0.0
    r = tp / (tp + fn) if tp + fn > 0 else 0.0
    f = 2 * p * r / (p + r) if p + r > 0 else 0.0
    return p, r, f


def multilabel_prf(probs: np.ndarray, targets: np.ndarray,
                   alpha: float = 0.5) -> Dict[str, float]:
    """Micro and macro precision/recall/F1 (sklearn-equivalent)."""
    pred = (np.asarray(probs) > alpha).astype(np.int32)
    tgt = np.asarray(targets).astype(np.int32)
    tp = (pred & tgt).sum(axis=0).astype(np.float64)
    fp = (pred & ~tgt.astype(bool)).sum(axis=0).astype(np.float64)
    fn = ((1 - pred) & tgt.astype(bool)).sum(axis=0).astype(np.float64)
    micro = _prf(tp.sum(), fp.sum(), fn.sum())
    per_class = [_prf(tp[i], fp[i], fn[i]) for i in range(len(tp))]
    macro = tuple(float(np.mean([c[i] for c in per_class])) for i in range(3))
    return {
        "micro_precision": micro[0], "micro_recall": micro[1],
        "micro_f1": micro[2],
        "macro_precision": macro[0], "macro_recall": macro[1],
        "macro_f1": macro[2],
    }
