"""Segmentation metrics: confusion matrices and mIoU / pAcc / mAcc.

Port of the JAX package's eval/metrics.py (numerical twins of the
reference's utils/evaluation.py:9-59). The confusion matrix is accumulated
on the device with :func:`torch_hist` and crosses to the host once, at the
end of an evaluation. The classification mAP is ``utils/metrics.py``'s
:func:`~cosa_tpu_torch.utils.metrics.compute_mAP`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def fast_hist(label_true: np.ndarray, label_pred: np.ndarray, n: int) -> np.ndarray:
    """Reference _fast_hist (utils/evaluation.py:9-15)."""
    mask = (label_true >= 0) & (label_true < n)
    return np.bincount(
        n * label_true[mask].astype(np.int64) + label_pred[mask],
        minlength=n * n,
    ).reshape(n, n)


def torch_hist(gt: torch.Tensor, pred: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n) int64 confusion matrix on gt's device, as :func:`fast_hist`:
    gt values outside [0, n) (the ignore label 255) drop the pixel, and
    predictions clip to [0, n - 1] (as the JAX package's ``jax_hist``). One
    ``bincount`` with the dropped pixels sent to an extra bin, so nothing
    waits for a data-dependent shape."""
    gt = gt.reshape(-1).to(torch.int64)
    pred = pred.reshape(-1).to(torch.int64).clamp(0, n - 1)
    idx = torch.where((gt >= 0) & (gt < n), gt * n + pred, n * n)
    return torch.bincount(idx, minlength=n * n + 1)[: n * n].reshape(n, n)


def scores_from_hist(hist: np.ndarray) -> Dict:
    """Reference scores() tail (utils/evaluation.py:21-35)."""
    hist = hist.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
    valid = hist.sum(axis=1) > 0
    mean_iu = np.nanmean(iu[valid])
    return {
        "pAcc": acc,
        "mAcc": acc_cls,
        "miou": mean_iu,
        "iou": dict(zip(range(hist.shape[0]), iu)),
    }


def scores(label_trues: Sequence, label_preds: Sequence, num_classes: int) -> Dict:
    hist = np.zeros((num_classes, num_classes), np.int64)
    for lt, lp in zip(label_trues, label_preds):
        hist += fast_hist(lt.flatten(), lp.flatten(), num_classes)
    return scores_from_hist(hist)


def pseudo_scores(label_trues: Sequence, label_preds: Sequence, num_classes: int) -> Dict:
    """Reference pseudo_scores (utils/evaluation.py:37-59): prediction 255
    (ignore band) removes the pixel from scoring."""
    hist = np.zeros((num_classes, num_classes), np.int64)
    for lt, lp in zip(label_trues, label_preds):
        lt = lt.flatten().copy()
        lp = lp.flatten().copy()
        lt[lp == 255] = 255
        lp[lp == 255] = 0
        hist += fast_hist(lt, lp, num_classes)
    return scores_from_hist(hist)
