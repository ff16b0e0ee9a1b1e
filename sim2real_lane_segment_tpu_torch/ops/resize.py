"""Image/label resize and normalization with cv2-matching semantics.

Counterpart of ``sim2real_lane_segment_tpu.ops.resize``:
- inputs: cv2.resize INTER_LINEAR (half-pixel centers, no antialiasing),
  which is ``F.interpolate(mode="bilinear", align_corners=False)``;
- labels: cv2.resize INTER_NEAREST, whose source index is
  ``floor(dst * src/dst)`` computed in float32.

Images are (..., H, W, C) like the JAX package, so the two agree
element for element.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ImageNet normalization (albumentations Normalize defaults).  The
# reference feeds cv2-read BGR images through these RGB-ordered constants;
# the quirk is kept by flowing BGR arrays through the same positional
# constants.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """cv2 INTER_LINEAR equivalent for (..., H, W, C) images (float32 out)."""
    *lead, h, w, c = img.shape
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2).to(torch.float32)
    y = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, height, width, c)


def resize_nearest_label(label: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """cv2 INTER_NEAREST equivalent for (..., H, W) integer label maps."""
    src_h, src_w = label.shape[-2], label.shape[-1]
    dev = label.device
    ys = (torch.arange(height, dtype=torch.float32, device=dev)
          * (src_h / height)).to(torch.int64).clamp(0, src_h - 1)
    xs = (torch.arange(width, dtype=torch.float32, device=dev)
          * (src_w / width)).to(torch.int64).clamp(0, src_w - 1)
    return label[..., ys[:, None], xs[None, :]]


def _channel_consts(x: torch.Tensor, values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=x.device)


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
              max_pixel: float = 255.0) -> torch.Tensor:
    return ((img.to(torch.float32) / max_pixel - _channel_consts(img, mean))
            / _channel_consts(img, std))


# The JAX package's ``normalize_flat`` is ``normalize`` on a flattened view
# so that TPU vector lanes carry pixels; the arithmetic is identical and a
# GPU gains nothing from the reshape, so it is the same function here.
normalize_flat = normalize


def to_gray(img: torch.Tensor, channel_order: str = "bgr") -> torch.Tensor:
    """Luma conversion replicated to 3 channels (albumentations ToGray)."""
    w = _channel_consts(img, (0.114, 0.587, 0.299) if channel_order == "bgr"
                        else (0.299, 0.587, 0.114))
    gray = torch.sum(img.to(torch.float32) * w, dim=-1, keepdim=True)
    return gray.expand(*img.shape[:-1], 3)
