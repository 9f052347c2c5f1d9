"""mIoU metric (port of mspl_tpu/engine/metrics.py): a confusion matrix per
batch on the device, accumulated on the host into per-class IoU and mIoU,
ignoring 255.  Only the [C, C] matrix crosses to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mspl_tpu_torch.utils.registry import IGNORE_LABEL


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int, ignore_label: int = IGNORE_LABEL,
                     batch_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """float32 [num_classes, num_classes] on pred's device, rows = ground
    truth.  pred/label: integer tensors of one shape; `batch_mask` [B]
    drops whole rows of the batch."""
    valid = label != ignore_label
    if batch_mask is not None:
        valid = valid & batch_mask.to(torch.bool).reshape(
            batch_mask.shape + (1,) * (label.dim() - batch_mask.dim()))
    lbl = torch.where(valid, label, 0).to(torch.int64)
    prd = pred.clamp(0, num_classes - 1).to(torch.int64)
    flat = (lbl * num_classes + prd).reshape(-1)
    cm = torch.zeros(num_classes * num_classes, dtype=torch.float32,
                     device=pred.device)
    cm.index_add_(0, flat, valid.reshape(-1).to(torch.float32))
    return cm.reshape(num_classes, num_classes)


def iou_from_confusion(cm) -> Tuple[np.ndarray, float]:
    """Per-class IoU and their mean over the classes that appear
    (nan-safe)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom > 0, tp / denom, np.nan)
    miou = float(np.nanmean(iou)) if np.isfinite(iou).any() else 0.0
    return iou.astype(np.float32), miou


class MIOU:
    """Streaming accumulator of confusion matrices (`get_iou()`)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), np.float64)

    def update(self, cm_batch) -> None:
        if isinstance(cm_batch, torch.Tensor):
            cm_batch = cm_batch.cpu().numpy()
        self.cm += np.asarray(cm_batch, np.float64)

    def update_preds(self, pred, label, batch_mask=None) -> None:
        self.update(confusion_matrix(
            torch.as_tensor(pred), torch.as_tensor(label), self.num_classes,
            batch_mask=None if batch_mask is None
            else torch.as_tensor(batch_mask)))

    def get_iou(self) -> Tuple[np.ndarray, float]:
        return iou_from_confusion(self.cm)

    def reset(self) -> None:
        self.cm[:] = 0
