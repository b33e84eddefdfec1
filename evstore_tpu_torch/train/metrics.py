"""Evaluation metrics (numpy, host-side).

A copy of `evstore_tpu/train/metrics.py`, kept here so the port imports
nothing of the JAX package.  The reference uses sklearn (roc_auc_score,
recall/precision/f1/average_precision, dlrm_s_pytorch.py:851-866).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney U), tie-aware — matches
    sklearn.metrics.roc_auc_score on binary labels."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(scores.size, dtype=np.float64)
    # average ranks for ties
    # vectorized tie-averaging
    _, inv, counts = np.unique(sorted_scores, return_inverse=True,
                               return_counts=True)
    csum = np.cumsum(counts)
    start = csum - counts
    avg = (start + csum + 1) / 2.0      # average rank per distinct value
    ranks[order] = avg[inv]
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """sklearn-style average_precision_score (step-wise integral of P at
    each recall increment)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = (np.asarray(labels).ravel() > 0.5).astype(np.float64)
    order = np.argsort(-scores, kind="mergesort")
    y = labels[order]
    s = scores[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1.0 - y)
    precision = tp / (tp + fp)
    recall = tp / max(y.sum(), 1.0)
    # evaluate only at distinct-threshold boundaries (last index of each run)
    distinct = np.r_[np.diff(s) != 0, True]
    p, r = precision[distinct], recall[distinct]
    return float(np.sum(np.diff(np.r_[0.0, r]) * p))


def binary_metrics(scores: np.ndarray, labels: np.ndarray,
                   threshold: float = 0.5) -> Dict[str, float]:
    """accuracy/recall/precision/f1/ap/auc, the reference's eval block
    (dlrm_s_pytorch.py:851-866)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = (np.asarray(labels).ravel() > 0.5)
    pred = scores >= threshold
    tp = int(np.sum(pred & labels))
    fp = int(np.sum(pred & ~labels))
    fn = int(np.sum(~pred & labels))
    tn = int(np.sum(~pred & ~labels))
    acc = (tp + tn) / max(labels.size, 1)
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "accuracy": float(acc),
        "recall": float(recall),
        "precision": float(precision),
        "f1": float(f1),
        "ap": average_precision(scores, labels),
        "auc": roc_auc(scores, labels),
    }
