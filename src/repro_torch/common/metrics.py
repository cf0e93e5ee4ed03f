"""Evaluation metrics (a copy of ``repro/common/metrics.py``; numpy only)."""
from __future__ import annotations

import numpy as np


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-statistic AUC (ties handled by average rank)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, np.float64)
    sorted_scores = scores[order]
    i = 0
    r = np.arange(1, scores.size + 1, dtype=np.float64)
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = r[i : j + 1].mean()
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def rolling_auc(labels: np.ndarray, scores: np.ndarray, window: int) -> np.ndarray:
    """AUC in non-overlapping windows (paper's 30k-instance rolling windows)."""
    out = []
    for i in range(0, labels.size - window + 1, window):
        out.append(roc_auc(labels[i : i + window], scores[i : i + window]))
    return np.asarray(out)


def log_loss(labels: np.ndarray, probs: np.ndarray) -> float:
    p = np.clip(np.asarray(probs, np.float64), 1e-12, 1 - 1e-12)
    y = np.asarray(labels, np.float64)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
