"""Supervised losses with the reference's semantics.

Counterpart of ``sim2real_lane_segment_tpu.train.losses``:
``get_class_weight``, ``cross_entropy``, ``weighted_cross_entropy``,
MME's ``adentropy``, and the reference's two spare losses
``iou_loss_thresholded`` and ``dice_loss`` (no caller, in either
package).
Outputs are NCHW (class axis 1), the port's model layout; targets are
(N, H, W) integer maps.  As in the reference, the trainer feeds the
model's *softmax* output to ``cross_entropy``, which applies
``log_softmax`` again: the double softmax is deliberate (QUIRKS.md).

In a data-parallel step (``parallel.dp``) the training losses are over
the global batch: the class counts and the weighted loss's denominator
are summed over the ranks, and each rank returns its share of the global
loss (the shares sum to it; ``dp.share``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dtypes import at_least_f32
from ..parallel import dp


def get_class_weight(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Inverse-frequency class weights over the batch; an absent class
    gets weight 0 (it indexes no pixel, so the loss is the same).  The
    counts go into ``num_classes`` bins of fixed size: ``torch.bincount``
    would read the largest label back to the host to size its output."""
    classes = torch.arange(num_classes, device=targets.device)
    counts = (targets.reshape(-1, 1).to(torch.int64) == classes).sum(0)
    counts = dp.all_sum(counts).to(torch.float32)
    return torch.where(counts > 0, 1.0 / torch.clamp(counts, min=1.0),
                       torch.zeros_like(counts))


def cross_entropy(outputs: torch.Tensor, targets: torch.Tensor,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """``torch.nn.functional.cross_entropy`` for (N, C, H, W) against
    (N, H, W): the weighted mean ``sum w[y] nll / sum w[y]``, or the plain
    mean without ``weight``."""
    logp = F.log_softmax(at_least_f32(outputs), dim=1)
    nll = -logp.gather(1, targets.to(torch.int64)[:, None])[:, 0]
    if weight is None:
        return dp.share(nll.mean())
    w = weight.to(torch.float32)[targets.to(torch.int64)]
    return (w * nll).sum() / torch.clamp(dp.all_sum(w.sum()), min=1e-12)


def weighted_cross_entropy(outputs: torch.Tensor, targets: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """``cross_entropy`` with this batch's inverse-frequency weights."""
    return cross_entropy(outputs, targets,
                         get_class_weight(targets, num_classes))


def adentropy(probs: torch.Tensor, lamda: float = 1.0) -> torch.Tensor:
    """MME's adversarial entropy (reference MMETrainingModule.py:10-11):
    ``lamda * mean over (N, H, W) of sum_c p * log(p + 1e-5)`` for (N, C,
    H, W) probabilities, the *negative* entropy.  Minimized through
    ``grad_reverse``, it maximizes the classifier's entropy on unlabelled
    target frames."""
    p = at_least_f32(probs)
    return lamda * dp.share(torch.mean(torch.sum(p * torch.log(p + 1e-5),
                                                 dim=1)))


def iou_loss_thresholded(outputs: torch.Tensor, labels: torch.Tensor,
                         smooth: float = 1e-6) -> torch.Tensor:
    """The reference's spare thresholded IoU (utils/losses.py:5-22):
    binary (N, H, W) masks -> the mean over samples of ``ceil(clip(20 *
    (iou - 0.5), 0, 10)) / 10``."""
    outputs, labels = outputs.to(torch.bool), labels.to(torch.bool)
    inter = (outputs & labels).sum((1, 2)).to(torch.float32)
    union = (outputs | labels).sum((1, 2)).to(torch.float32)
    iou = (inter + smooth) / (union + smooth)
    return torch.mean(torch.ceil(torch.clamp(20 * (iou - 0.5), 0, 10)) / 10)


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """The reference's spare differentiable Dice loss
    (utils/losses.py:25-41)."""
    p, t = pred.reshape(-1), target.reshape(-1)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter + smooth) / (torch.sum(t * p) + torch.sum(t * t)
                                           + smooth)
