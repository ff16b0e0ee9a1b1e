"""Segmentation metrics with the reference's (pytorch-lightning 1.x)
semantics.

Counterpart of ``sim2real_lane_segment_tpu.ops.metrics``.  Metrics take
integer class maps of any shape; ``evaluate_outputs`` takes NCHW
probabilities (class axis 1), the port's model layout.

- ``accuracy``: mean(pred == target).
- ``confusion_matrix``: rows = target, cols = prediction, counts.
- ``iou``: per-class I/U (0 where the union is empty), averaged over
  ``max(pred, target) + 1`` classes, as PL inferred the class count.
- ``dice_score``: mean over the foreground classes 1..C-1 of 2tp/(2tp +
  fp + fn); a class absent from the target scores 0.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred == target).to(torch.float32).mean()


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    idx = (target.reshape(-1).to(torch.int64) * num_classes
           + pred.reshape(-1).to(torch.int64))
    cm = torch.bincount(idx, minlength=num_classes * num_classes)
    return cm[:num_classes * num_classes].reshape(
        num_classes, num_classes).to(torch.int32)


def iou(pred: torch.Tensor, target: torch.Tensor,
        num_classes: int) -> torch.Tensor:
    cm = confusion_matrix(pred, target, num_classes).to(torch.float32)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    scores = torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                         torch.zeros_like(union))
    n = int(torch.maximum(pred.max(), target.max())) + 1
    return scores[:n].sum() / n


def dice_score(pred: torch.Tensor, target: torch.Tensor,
               num_classes: int) -> torch.Tensor:
    cm = confusion_matrix(pred, target, num_classes).to(torch.float32)
    tp = torch.diagonal(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = 2 * tp + fp + fn
    per_class = torch.where(denom > 0, 2 * tp / torch.clamp(denom, min=1.0),
                            torch.zeros_like(denom))
    per_class = torch.where(cm.sum(1) > 0, per_class,
                            torch.zeros_like(per_class))
    return per_class[1:].mean()


def evaluate_outputs(probas: torch.Tensor, target: torch.Tensor,
                     loss: torch.Tensor,
                     num_classes: int) -> Dict[str, torch.Tensor]:
    """One batch's metrics, each pre-multiplied by the batch size
    (``weight``) for ``summarize_weighted``.  probas: (N, C, H, W)."""
    pred = torch.argmax(probas, dim=1)
    target = target.to(torch.int64)
    w = float(probas.shape[0])
    return {"loss": loss * w, "acc": accuracy(pred, target) * w,
            "dice": dice_score(pred, target, num_classes) * w,
            "iou": iou(pred, target, num_classes) * w,
            "weight": torch.tensor(w)}


def summarize_weighted(outputs: List[Dict]) -> Dict[str, float]:
    """Weighted epoch aggregation; acc and iou scaled by 100 as the
    reference logs them."""
    total = float(sum(float(o["weight"]) for o in outputs))

    def s(k):
        return float(sum(float(o[k]) for o in outputs)) / total

    return {"loss": s("loss"), "acc": s("acc") * 100.0, "dice": s("dice"),
            "iou": s("iou") * 100.0}
