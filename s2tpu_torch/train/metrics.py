"""Segmentation metrics from a confusion matrix (the port of ``s2tpu/train/metrics.py``).

The (K, K) confusion matrix is built on the device with one ``index_add_``
into a fixed K*K buffer per step (``bincount`` would read the input's range
on the host, which a CUDA graph cannot capture); IoU, accuracy, F1 and the normalized matrix derive from it on the host
at epoch end (numpy copies of the JAX package's closed forms).
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix_update(
    preds: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    ignore_index: int | None = None,
    batch_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(K, K) f32 counts with rows = true class, cols = predicted class: the
    validity weights added at ``label * K + pred`` (``s2tpu/train/metrics.py:17-49``).
    Labels outside [0, K) are dropped, as the JAX one-hot drops them. The
    weights are 0 or 1, so the f32 sums are exact in any order below 2^24
    counts a cell."""
    preds = preds.reshape(preds.shape[0], -1).long()
    labels = labels.reshape(labels.shape[0], -1).long()
    valid = (labels >= 0) & (labels < num_classes)
    if ignore_index is not None:
        valid = valid & (labels != ignore_index)
    weights = valid.to(torch.float32)
    if batch_mask is not None:
        weights = weights * batch_mask.to(torch.float32)[:, None]
    flat = torch.where(valid, labels * num_classes + preds, 0)
    counts = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=flat.device)
    counts.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    return counts.reshape(num_classes, num_classes)


def compute_metrics(cm, ignore_background: bool = False, exclude_index: int | None = None) -> dict:
    """Closed-form metrics from an accumulated confusion matrix
    (``s2tpu/train/metrics.py:52-103``): mIoU (macro over classes with
    support), per-class IoU, micro accuracy, macro F1 and the row-normalized
    matrix. ``exclude_index`` drops that class from the macro means
    (torchmetrics' ``ignore_index`` averaging) while its column stays in
    every other class's union."""
    cm = np.asarray(cm, np.float64)
    if ignore_background:
        cm = cm[1:, 1:]
    tp = np.diag(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    support = cm.sum(1)
    union = tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, tp / np.maximum(union, 1e-12), np.nan)
        f1 = np.where((2 * tp + fp + fn) > 0, 2 * tp / np.maximum(2 * tp + fp + fn, 1e-12), np.nan)
        cm_norm = cm / np.maximum(support[:, None], 1e-12)
    if exclude_index is not None and not ignore_background and 0 <= exclude_index < len(iou):
        iou[exclude_index] = np.nan
        f1[exclude_index] = np.nan
    present = ~np.isnan(iou)
    total = cm.sum()
    return {
        "iou": float(np.nanmean(iou)) if present.any() else 0.0,
        "per_class_iou": iou,
        "accuracy": float(tp.sum() / total) if total > 0 else 0.0,
        "f1": float(np.nanmean(f1)) if present.any() else 0.0,
        "confusion_matrix": cm_norm,
        "support": support,
    }


class MetricAccumulator:
    """Host-side epoch accumulator over confusion matrices + loss."""

    def __init__(self, num_classes: int, ignore_index: int | None = None) -> None:
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self.cm = np.zeros((self.num_classes, self.num_classes), np.float64)
        self.loss_sum = 0.0
        self.loss_count = 0

    def update(self, cm, loss: float | None = None) -> None:
        self.cm += np.asarray(cm, np.float64)
        if loss is not None:
            self.loss_sum += float(loss)
            self.loss_count += 1

    def compute(self, ignore_background_in_cm: bool = False) -> dict:
        out = compute_metrics(self.cm, ignore_background=ignore_background_in_cm, exclude_index=self.ignore_index)
        if self.loss_count:
            out["loss"] = self.loss_sum / self.loss_count
        return out
