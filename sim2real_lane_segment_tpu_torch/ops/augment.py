"""Eval-time input transform (the reference's MyTransform, eval branch).

Counterpart of ``sim2real_lane_segment_tpu.ops.augment``: ``AugmentConfig``
and ``eval_batch``.  The training augmentation (``augment_batch``) belongs
to the training slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .resize import normalize_flat, resize_bilinear, resize_nearest_label, \
    to_gray


class AugmentConfig(NamedTuple):
    height: int = 120
    width: int = 160
    gray: bool = False
    # albumentations defaults (reference myTransforms.py:8-13)
    hue_limit: float = 20.0
    sat_limit: float = 30.0
    val_limit: float = 20.0
    min_crop_height: int = 60      # height // 2
    max_crop_height: int = 480     # height * 4
    noise_var_min: float = 10.0
    noise_var_max: float = 50.0
    channel_order: str = "bgr"


def eval_batch(images: torch.Tensor, labels: torch.Tensor | None,
               cfg: AugmentConfig = AugmentConfig(),
               with_labels: bool = True):
    """Resize -> [ToGray] -> Normalize (+ nearest label resize).

    images: (N, H, W, 3) uint8 on any device.  Returns float32
    (N, height, width, 3) and int32 labels (or None), like the JAX
    function.
    """
    if tuple(images.shape[-3:-1]) == (cfg.height, cfg.width):
        x = images.to(torch.float32)  # already target size: skip resample
    else:
        x = resize_bilinear(images, cfg.height, cfg.width)
    if cfg.gray:
        x = to_gray(x, cfg.channel_order)
    x = normalize_flat(x)
    y = None
    if with_labels and labels is not None:
        y = labels
        if tuple(y.shape[-2:]) != (cfg.height, cfg.width):
            y = resize_nearest_label(y, cfg.height, cfg.width)
        y = y.to(torch.int32)
    return x, y
