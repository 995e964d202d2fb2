"""Classification mAP for the training log, in numpy (the JAX package's
eval/metrics.py::compute_mAP calls scikit-learn, which the port does not
need: this is sklearn's ``average_precision_score`` for binary labels)."""

from __future__ import annotations

from typing import List

import numpy as np


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """sum_k (R_k - R_{k-1}) P_k over the distinct score thresholds."""
    order = np.argsort(-np.asarray(scores, np.float64), kind="mergesort")
    y = np.asarray(labels, np.float64)[order]
    s = np.asarray(scores, np.float64)[order]
    idx = np.r_[np.where(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    precision = tps / (idx + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def compute_mAP(labels: np.ndarray, probs: np.ndarray) -> List[float]:
    """Per-sample average precision over classes (reference
    utils/torch_helper.py:140-148)."""
    return [average_precision(labels[i], probs[i])
            for i in range(labels.shape[0]) if labels[i].sum() > 0]
