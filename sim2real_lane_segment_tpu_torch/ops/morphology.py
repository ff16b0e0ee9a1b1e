"""Binary morphology on bool masks with cv2's border values.

Counterpart of ``sim2real_lane_segment_tpu.ops.morphology``, which matches
``cv2.morphologyEx`` with a size x size rect kernel bit for bit:

- erosion = min over the window; cv2 pads the border with the type max,
  so pixels outside the image never win the min;
- dilation = max over the window; cv2 pads with the type min.

``F.max_pool2d`` pads with -inf, the identity of max, which is dilation's
border; erosion is the complement of the dilation of the complement.
Masks are (..., H, W); the window runs over the last two axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Binary dilation with a size x size rect structuring element."""
    *lead, h, w = mask.shape
    m = mask.to(torch.bool).reshape(-1, 1, h, w).to(torch.float32)
    y = F.max_pool2d(m, size, stride=1, padding=size // 2)
    return (y > 0).reshape(*lead, h, w)


def erode(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Binary erosion with a size x size rect structuring element."""
    return ~dilate(~mask.to(torch.bool), size)


def morph_open(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    return dilate(erode(mask, size), size)


def morph_close(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    return erode(dilate(mask, size), size)
