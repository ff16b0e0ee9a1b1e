"""Supervised losses with the reference's semantics.

Counterpart of ``sim2real_lane_segment_tpu.train.losses``:
``get_class_weight``, ``cross_entropy``, ``weighted_cross_entropy`` and
MME's ``adentropy``.
Outputs are NCHW (class axis 1), the port's model layout; targets are
(N, H, W) integer maps.  As in the reference, the trainer feeds the
model's *softmax* output to ``cross_entropy``, which applies
``log_softmax`` again: the double softmax is deliberate (QUIRKS.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dtypes import at_least_f32


def get_class_weight(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Inverse-frequency class weights over the batch; an absent class
    gets weight 0 (it indexes no pixel, so the loss is the same).  The
    counts go into ``num_classes`` bins of fixed size: ``torch.bincount``
    would read the largest label back to the host to size its output."""
    classes = torch.arange(num_classes, device=targets.device)
    counts = (targets.reshape(-1, 1).to(torch.int64) == classes).sum(0)
    counts = counts.to(torch.float32)
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
        return nll.mean()
    w = weight.to(torch.float32)[targets.to(torch.int64)]
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)


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
    return lamda * torch.mean(torch.sum(p * torch.log(p + 1e-5), dim=1))
