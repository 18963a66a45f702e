"""Evaluation metrics (counterpart of
``distributed_embeddings_tpu/utils/metrics.py``; the reference evaluates
with Keras ``AUC``, ``examples/dlrm/main.py:223-243``). Host numpy."""

from __future__ import annotations

import numpy as np


def binary_auc(labels: np.ndarray, predictions: np.ndarray) -> float:
    """Exact ROC AUC via the rank statistic (the trapezoidal ROC integral
    at every threshold, ties given their average rank; no binning error,
    unlike the reference's 8000-bucket Keras metric). ``nan`` when one
    class is missing."""
    labels = np.asarray(labels).reshape(-1)
    predictions = np.asarray(predictions).reshape(-1)
    order = np.argsort(predictions, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    sorted_pred = predictions[order]
    uniq, inv, counts = np.unique(sorted_pred, return_inverse=True,
                                  return_counts=True)
    if len(uniq) != len(sorted_pred):
        cum = np.cumsum(counts)
        avg_rank = cum - (counts - 1) / 2.0
        ranks[order] = avg_rank[inv]
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
