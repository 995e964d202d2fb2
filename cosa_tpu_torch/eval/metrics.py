"""Segmentation metrics: confusion matrices and mIoU / pAcc / mAcc.

Port of the JAX package's eval/metrics.py (numerical twins of the
reference's utils/evaluation.py:9-59). The confusion matrix is accumulated
on the device with :func:`torch_hist` and crosses to the host once, at the
end of an evaluation. The classification mAP is ``utils/metrics.py``'s
:func:`~cosa_tpu_torch.utils.metrics.compute_mAP`. :class:`Evaluator` is
the reference's unused incremental metrics class (utils/metrics.py:4-66).
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


class Evaluator:
    """Incremental confusion-matrix evaluator (reference utils/metrics.py:4-66,
    unused in the live path), on the host. ``ignore=True`` treats the LAST
    class as an ignore bucket and drops it from the class-averaged metrics;
    gt values outside [0, num_class) drop the pixel."""

    def __init__(self, num_class: int, ignore: bool = False):
        self.num_class = num_class
        self.ignore = ignore
        self.confusion_matrix = np.zeros((num_class, num_class), np.float64)

    def add_batch(self, gt_image: np.ndarray, pre_image: np.ndarray) -> None:
        assert gt_image.shape == pre_image.shape, (gt_image.shape, pre_image.shape)
        self.confusion_matrix += fast_hist(gt_image.flatten(), pre_image.flatten(),
                                           self.num_class)

    def reset(self) -> None:
        self.confusion_matrix = np.zeros((self.num_class, self.num_class), np.float64)

    def _maybe_drop(self, per_class: np.ndarray) -> np.ndarray:
        return per_class[:-1] if self.ignore else per_class

    def Precision_Recall(self):
        h = self.confusion_matrix
        precision = np.diag(h) / (h.sum(axis=0) + 1e-5)
        recall = np.diag(h) / (h.sum(axis=1) + 1e-5)
        return (precision, recall, np.nanmean(self._maybe_drop(precision)),
                np.nanmean(self._maybe_drop(recall)))

    def Pixel_Accuracy(self) -> float:
        h = self.confusion_matrix
        return np.diag(h).sum() / h.sum()

    def Pixel_Accuracy_Class(self) -> float:
        h = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(h) / h.sum(axis=1)
        return np.nanmean(self._maybe_drop(acc))

    def Mean_Intersection_over_Union(self):
        h = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(h) / (h.sum(axis=1) + h.sum(axis=0) - np.diag(h))
        iou = self._maybe_drop(iou)
        return iou, np.nanmean(iou)

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        h = self.confusion_matrix
        freq = h.sum(axis=1) / h.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(h) / (h.sum(axis=1) + h.sum(axis=0) - np.diag(h))
        return (freq[freq > 0] * iu[freq > 0]).sum()
