"""Colour-space ops of the training augmentation (HSV jitter).

Counterpart of ``sim2real_lane_segment_tpu.ops.colorspace``: the
reference's HueSaturationValue ran in cv2's uint8 HSV ranges (hue 0..179
wrapping, saturation and value 0..255 clipped); here it runs in float32
with the same ranges and the JAX functions' order of operations.
``jnp.mod`` is a floor modulo, which is ``torch.remainder``.
"""
from __future__ import annotations

import torch


def rgb_to_hsv_cv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) float image in [0, 255], R, G, B order -> HSV with H in
    [0, 180) and S, V in [0, 255]."""
    img = img.to(torch.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    # hue in degrees [0, 360)
    h = torch.where(v == r, 60.0 * (g - b) / safe_c,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_c,
                                240.0 + 60.0 * (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h, 360.0), torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v))
                    * 255.0, torch.zeros_like(v))
    return torch.stack([h / 2.0, s, v], dim=-1)  # cv2: hue halved


def hsv_to_rgb_cv(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of ``rgb_to_hsv_cv``: float in [0, 255], R, G, B order."""
    h = hsv[..., 0] * 2.0  # degrees
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    i = torch.remainder(torch.floor(hp).to(torch.int32), 6)
    # the sextant's (r, g, b) as (c, x, 0) permutations, jnp.select's order
    table = ((c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c),
             (c, z, x))
    out = []
    for ch in range(3):
        val = z
        for k in reversed(range(6)):
            val = torch.where(i == k, table[k][ch], val)
        out.append(val)
    m = v - c
    return torch.stack([out[0] + m, out[1] + m, out[2] + m], dim=-1)


def shift_hsv(img: torch.Tensor, hue_shift, sat_shift, val_shift,
              channel_order: str = "bgr") -> torch.Tensor:
    """HueSaturationValue jitter in cv2's uint8 value ranges.

    The shifts are scalars or tensors that broadcast against the image's
    leading axes (one per sample: shape (N, 1, 1) for (N, H, W, 3)).
    Hue is in cv2 units (wrapping at 180), saturation and value in [0, 255].
    """
    x = img.to(torch.float32)
    if channel_order == "bgr":
        x = x.flip(-1)
    hsv = rgb_to_hsv_cv(x)
    h = torch.remainder(hsv[..., 0] + hue_shift, 180.0)
    s = torch.clamp(hsv[..., 1] + sat_shift, 0.0, 255.0)
    v = torch.clamp(hsv[..., 2] + val_shift, 0.0, 255.0)
    out = hsv_to_rgb_cv(torch.stack([h, s, v], dim=-1))
    if channel_order == "bgr":
        out = out.flip(-1)
    return torch.clamp(out, 0.0, 255.0)
