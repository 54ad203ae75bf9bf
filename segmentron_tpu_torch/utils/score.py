"""Segmentation metrics: streaming confusion-matrix pixAcc / mIoU
(counterpart of ``segmentron_tpu/utils/score.py``).

The per-batch update is one ``bincount`` on the tensors' device; the
``nclass x nclass`` matrix accumulates in int64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["confusion_matrix_update", "SegmentationMetric"]


def confusion_matrix_update(
    pred: torch.Tensor, target: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """``(num_classes, num_classes)`` int64 confusion matrix.

    ``pred``: int class ids, any shape. ``target``: same shape; pixels
    with ``target < 0`` or ``target >= num_classes`` are ignored (the
    datasets map their ignore label to -1). Rows = target class, cols =
    predicted class."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = (target >= 0) & (target < num_classes)
    idx = target[valid] * num_classes + pred[valid].clamp(0, num_classes - 1)
    cm = torch.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


class SegmentationMetric:
    """Streaming metric accumulator.

    ``update`` takes logits ``(..., H, W, C)`` (argmax over the last
    dim) or hard predictions, and int targets."""

    def __init__(self, nclass: int):
        self.nclass = nclass
        self.reset()

    def reset(self) -> None:
        self._cm = np.zeros((self.nclass, self.nclass), np.int64)

    def update(self, preds, labels) -> None:
        preds = torch.as_tensor(preds)
        labels = torch.as_tensor(labels, device=preds.device)
        if preds.ndim == labels.ndim + 1:
            preds = preds.argmax(dim=-1)
        self.update_cm(confusion_matrix_update(preds, labels, self.nclass))

    def update_cm(self, cm) -> None:
        """Add a batch's (nclass, nclass) confusion matrix (a tensor on any
        device, or numpy), as the train loop's eval step returns it."""
        cm = cm.cpu().numpy() if isinstance(cm, torch.Tensor) else np.asarray(cm)
        self._cm += cm.astype(np.int64)

    @property
    def confusion_matrix(self) -> np.ndarray:
        return self._cm.copy()

    def get(self, return_category_iou: bool = False):
        """(pixAcc, mIoU): classes with union 0 (absent from target and
        prediction) are left out of the mean."""
        total = self._cm.sum()
        pix_acc = np.diag(self._cm).sum() / max(total, 1)
        inter = np.diag(self._cm).astype(np.float64)
        union = self._cm.sum(0) + self._cm.sum(1) - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
        miou = np.nanmean(iou) if np.any(union > 0) else 0.0
        if return_category_iou:
            return float(pix_acc), float(miou), iou
        return float(pix_acc), float(miou)
