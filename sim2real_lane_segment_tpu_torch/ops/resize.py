"""Image/label resize and normalization with cv2-matching semantics.

Counterpart of ``sim2real_lane_segment_tpu.ops.resize``:
- inputs: cv2.resize INTER_LINEAR (half-pixel centers, no antialiasing),
  which is ``F.interpolate(mode="bilinear", align_corners=False)``;
- labels: cv2.resize INTER_NEAREST, whose source index is
  ``floor(dst * src/dst)`` computed in float32;
- uint8 frames: cv2.resize INTER_CUBIC and INTER_LANCZOS4
  (``resize_cubic_u8``, ``resize_lanczos4_u8``), which the JAX package's
  CycleGAN CLIs call on the host.  They repeat OpenCV's own fixed-point
  arithmetic, so the result is cv2's byte for byte.

Images are (..., H, W, C) like the JAX package, so the two agree
element for element.
"""
from __future__ import annotations

import functools
import math

import numpy as np
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
    return device_constant(tuple(values), x.device)


@functools.cache
def device_constant(values, device: torch.device) -> torch.Tensor:
    """``values`` (a float or a tuple of floats) as a float32 tensor on
    ``device``, made once per device: an upload at every call would cost
    host time and could not be captured in a CUDA graph."""
    with torch.inference_mode(False):  # a normal tensor, usable anywhere
        return torch.tensor(values, dtype=torch.float32, device=device)


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


# ---------------------------------------------------------------------------
# cv2 INTER_CUBIC and INTER_LANCZOS4 on uint8 frames
# ---------------------------------------------------------------------------

# OpenCV's fixed point: coefficients scaled by 2^11 and rounded to int16;
# the two passes' product is scaled back by 2^22.
_COEF_SCALE = 2048
_SHIFT = 22
# int16 lanes of OpenCV's 128-bit baseline SIMD: its vertical cubic pass
# runs in float32 over the first multiple of 8 values of a row and in
# integers over the rest
_CUBIC_LANES = 8
_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = np.array([[1, 0], [-_S45, -_S45], [0, 1], [_S45, -_S45],
                        [-1, 0], [_S45, _S45], [0, -1], [-_S45, _S45]])


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """OpenCV ``interpolateCubic`` (A = -0.75) in float32, term for
    term."""
    f32 = np.float32
    a, one = f32(-0.75), f32(1)
    x1 = x + one
    c0 = ((a * x1 - f32(5) * a) * x1 + f32(8) * a) * x1 - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    y = one - x
    c2 = ((a + f32(2)) * y - (a + f32(3))) * y * y + one
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], 1)


def _lanczos4_coeffs(x: np.ndarray) -> np.ndarray:
    """OpenCV ``interpolateLanczos4``: sines in float64, each tap rounded
    to float32, normalised by a float32 sum; x == 0 is the identity."""
    y0 = -(x + np.float32(3)).astype(np.float64) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    taps = np.empty((len(x), 8), np.float32)
    total = np.zeros(len(x), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(8):
            y = -((x + np.float32(3)) - np.float32(i)).astype(
                np.float64) * math.pi * 0.25
            taps[:, i] = ((_LANCZOS_CS[i, 0] * s0 + _LANCZOS_CS[i, 1] * c0)
                          / (y * y))
            total += taps[:, i]
        taps *= (np.float32(1) / total)[:, None]
    zero = x == 0
    taps[zero] = 0
    taps[zero, 3] = 1
    return taps


@functools.cache
def _resample_taps(src: int, dst: int, kind: str):
    """Source indices (clamped to the border) and int16 coefficients,
    [dst, taps] each, of OpenCV's ``resizeGeneric_`` along one axis."""
    scale = 1.0 / (dst / src)  # OpenCV's double scale, as it computes it
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    coeffs = _cubic_coeffs(f) if kind == "cubic" else _lanczos4_coeffs(f)
    k = coeffs.shape[1]
    idx = np.clip(s.astype(np.int64)[:, None] - (k // 2 - 1)
                  + np.arange(k)[None], 0, src - 1)
    ic = np.rint(coeffs * np.float32(_COEF_SCALE)).astype(np.int64)
    return idx, ic


def _resample_u8(img: torch.Tensor, height: int, width: int,
                 kind: str) -> torch.Tensor:
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 frames, got {img.dtype}")
    *lead, h, w, c = img.shape
    x = img.reshape(-1, h, w, c).to(torch.int64)
    dev = img.device
    ix, cx = (torch.from_numpy(a).to(dev)
              for a in _resample_taps(w, width, kind))
    iy, cy = (torch.from_numpy(a).to(dev)
              for a in _resample_taps(h, height, kind))
    # horizontal pass: integer sums along each row
    hor = sum(x[:, :, ix[:, k], :] * cx[:, k, None]
              for k in range(ix.shape[1]))
    rows = [hor[:, iy[:, k]] for k in range(iy.shape[1])]
    acc = sum(r * cy[:, k, None, None] for k, r in enumerate(rows))
    out = ((acc + (1 << (_SHIFT - 1))) >> _SHIFT).clamp(0, 255)
    if kind == "cubic":
        # OpenCV's VResizeCubicVec_32s8u: float32 products summed from the
        # last tap to the first, rounded half to even
        beta = cy.to(torch.float32) * (1.0 / (_COEF_SCALE * _COEF_SCALE))
        t = rows[3].to(torch.float32) * beta[:, 3, None, None]
        for k in (2, 1, 0):
            t = rows[k].to(torch.float32) * beta[:, k, None, None] + t
        vec = torch.round(t).clamp(0, 255).to(torch.int64)
        n = width * c
        lanes = (torch.arange(n, device=dev)
                 < n - n % _CUBIC_LANES).reshape(width, c)
        out = torch.where(lanes, vec, out)
    return out.to(torch.uint8).reshape(*lead, height, width, c)


def resize_cubic_u8(img: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=INTER_CUBIC)`` for
    (..., H, W, C) uint8, on ``img``'s device.

    OpenCV's own kernel, byte for byte: 4 taps (A = -0.75) at source
    ``(d + 0.5) * src/dst - 0.5``, int16 coefficients, edge taps clamped.
    A cv2 built with Intel IPP (the pip wheels) hands some calls to IPP,
    whose cubic rounds otherwise: up to 1 level apart on a few percent of
    the values."""
    return _resample_u8(img, height, width, "cubic")


def resize_lanczos4_u8(img: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=INTER_LANCZOS4)``
    for (..., H, W, C) uint8, on ``img``'s device: 8 taps, int16
    coefficients, integer sums, ``(acc + 2^21) >> 22`` saturated."""
    return _resample_u8(img, height, width, "lanczos4")
