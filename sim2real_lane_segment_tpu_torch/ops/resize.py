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


@functools.cache
def upsample_matrix(n: int, scale: int, device: torch.device) -> torch.Tensor:
    """[scale * n, n] float32: row i holds the two weights of the bilinear
    upsample by ``scale`` (half-pixel centers, clamped at the border,
    ``jax.image.resize``'s ``"bilinear"``) at output i.  Made outside
    inference mode, so that a forward that records gradients can keep the
    cached matrix for its backward."""
    with torch.inference_mode(False):
        return _upsample_matrix(n, scale, device)


def _upsample_matrix(n, scale, device):
    src = torch.clamp((torch.arange(scale * n, dtype=torch.float64) + 0.5)
                      / scale - 0.5, min=0.0)
    i0 = src.floor().to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    lam = src - i0
    a = torch.zeros(scale * n, n, dtype=torch.float64)
    rows = torch.arange(scale * n)
    a.index_put_((rows, i0), 1.0 - lam, accumulate=True)
    a.index_put_((rows, i1), lam, accumulate=True)
    return a.to(device=device, dtype=torch.float32)


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
    coefficients, integer sums, ``(acc + 2^21) >> 22`` saturated.  At the
    frame's own size the taps are one 2048 each way, so the frame comes
    back unchanged, as cv2 copies it."""
    return _resample_u8(img, height, width, "lanczos4")


# ---------------------------------------------------------------------------
# cv2 INTER_LINEAR, INTER_AREA and INTER_NEAREST on uint8, INTER_CUBIC on
# float32, and COLOR_BGR2GRAY: the host-side image ops of the data tools
# ---------------------------------------------------------------------------

# lanes of OpenCV's 128-bit baseline SIMD for float32
_F32_LANES = 4
# COLOR_BGR2GRAY: 15-bit fixed-point coefficients of B, G, R
_GRAY_COEFS = (3735, 19235, 9798)
_GRAY_SHIFT = 15


def _as_hwc(img: torch.Tensor):
    """(..., H, W, C), or one (H, W) gray image -> ((N, H, W, C) view, a
    function restoring the caller's shape at the new H, W).  A batch of
    gray images takes a channel dim of 1."""
    gray = img.dim() == 2
    x = img[..., None] if gray else img
    *lead, h, w, c = x.shape

    def back(y):
        y = y.reshape(*lead, y.shape[1], y.shape[2], c)
        return y[..., 0] if gray else y
    return x.reshape(-1, h, w, c), back


@functools.cache
def _linear_taps(src: int, dst: int, clamp: bool, area: bool):
    """Source indices and int16 coefficients, [dst, 2] each, of OpenCV's
    linear ``resizeGeneric_`` along one axis (``clamp``: the x axis, whose
    border taps collapse to one source pixel; ``area``: the coefficients
    INTER_AREA uses when it enlarges)."""
    scale = src / dst
    d = np.arange(dst)
    if area:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * (dst / src)).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s).astype(np.float32)
    if clamp:
        lo = s < 0
        f, s = np.where(lo, np.float32(0), f), np.where(lo, 0, s)
        hi = s >= src - 1
        f, s = np.where(hi, np.float32(0), f), np.where(hi, src - 1, s)
    c = np.stack([np.float32(1) - f, f], 1)
    coef = np.rint(c * np.float32(_COEF_SCALE)).astype(np.int64)
    idx = np.clip(s[:, None] + np.arange(2)[None], 0, src - 1)
    return idx, coef


def _linear_u8(img: torch.Tensor, height: int, width: int,
               area: bool) -> torch.Tensor:
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 frames, got {img.dtype}")
    x, back = _as_hwc(img)
    _, h, w, _ = x.shape
    dev = img.device
    ix, cx = (torch.from_numpy(a).to(dev)
              for a in _linear_taps(w, width, True, area))
    iy, cy = (torch.from_numpy(a).to(dev)
              for a in _linear_taps(h, height, False, area))
    x = x.to(torch.int64)
    hor = (x[:, :, ix[:, 0]] * cx[:, 0, None]
           + x[:, :, ix[:, 1]] * cx[:, 1, None])
    # OpenCV's VResizeLinearVec_32s8u, which every column takes: the rows
    # shifted right by 4, multiplied keeping the high 16 bits, rounded by 2
    s0 = ((hor[:, iy[:, 0]] >> 4) * cy[:, 0, None, None]) >> 16
    s1 = ((hor[:, iy[:, 1]] >> 4) * cy[:, 1, None, None]) >> 16
    out = ((s0 + s1 + 2) >> 2).clamp(0, 255)
    return back(out.to(torch.uint8))


def resize_linear_u8(img: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) for uint8
    (..., H, W, C) (or (H, W)) with OpenCV's fixed point: 11-bit
    coefficients (x clamped at the border, y rows clipped), the horizontal
    pass in integers, the vertical pass as its SIMD kernel computes it.  A
    halving of both sides is cv2's INTER_AREA, which the same sums give."""
    return _linear_u8(img, height, width, False)


@functools.cache
def _area_taps(src: int, dst: int):
    """OpenCV's ``computeResizeAreaTab``: [dst, k] source indices and
    float32 weights (0 past a cell's last tap)."""
    scale = src / dst
    rows = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, np.float32((s1 - fs1) / cell)))
        taps += [(s, np.float32(1.0 / cell)) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, np.float32(min(min(fs2 - s2, 1.0), cell)
                                        / cell)))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    alpha = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], alpha[d, j] = s, a
    return idx, alpha


def resize_area_u8(img: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=INTER_AREA)`` for
    uint8 (..., H, W, C) (or (H, W)).

    OpenCV's three routes: integer shrink factors average each cell (a
    halving rounds half up as its SIMD kernel does, other factors round
    the float32 mean half to even); other shrinks weight the cells'
    pixels in float32 (``computeResizeAreaTab``), summed row by row in
    table order; an enlargement is its linear route with INTER_AREA's
    coefficients.  A frame at its own size comes back unchanged."""
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 frames, got {img.dtype}")
    x, back = _as_hwc(img)
    _, h, w, _ = x.shape
    if (h, w) == (height, width):
        return img.clone()
    if height > h or width > w:
        return _linear_u8(img, height, width, True)
    sx, sy = w / width, h / height
    if sx == int(sx) and sy == int(sy):
        sx, sy = int(sx), int(sy)
        cells = x.to(torch.int64)[:, :height * sy, :width * sx].reshape(
            x.shape[0], height, sy, width, sx, x.shape[3]).sum((2, 4))
        if (sx, sy) == (2, 2):
            out = (cells + 2) >> 2
        else:
            out = torch.round(cells.to(torch.float32)
                              * np.float32(1.0 / (sx * sy)))
        return back(out.clamp(0, 255).to(torch.uint8))
    dev = img.device
    ix, ax = (torch.from_numpy(a).to(dev) for a in _area_taps(w, width))
    iy, ay = (torch.from_numpy(a).to(dev) for a in _area_taps(h, height))
    xf = x.to(torch.float32)
    buf = torch.zeros(x.shape[0], h, width, x.shape[3], device=dev)
    for j in range(ix.shape[1]):
        buf = buf + xf[:, :, ix[:, j]] * ax[:, j, None]
    acc = buf[:, iy[:, 0]] * ay[:, 0, None, None]
    for j in range(1, iy.shape[1]):
        acc = acc + buf[:, iy[:, j]] * ay[:, j, None, None]
    return back(torch.round(acc).clamp(0, 255).to(torch.uint8))


def resize_nearest_u8(img: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``
    for (..., H, W, C) (or (H, W)): source index ``floor(d * src/dst)`` in
    float64, as OpenCV's ``resizeNN`` computes it."""
    x, back = _as_hwc(img)
    _, h, w, _ = x.shape
    dev = img.device
    sx = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))),
                    w - 1).astype(np.int64)
    sy = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))),
                    h - 1).astype(np.int64)
    out = x[:, torch.from_numpy(sy).to(dev)][:, :, torch.from_numpy(sx)
                                             .to(dev)]
    return back(out)


def resize_cubic_f32(img: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=INTER_CUBIC)`` for
    float32 (..., H, W, C) (or (H, W)) with OpenCV's own float arithmetic:
    float32 coefficients, the horizontal taps summed first to last, the vertical
    ones last to first over the first multiple of 4 values of a row (its
    SIMD kernel) and first to last over the rest.  cv2 with IPP enabled
    hands some calls to IPP, which sums otherwise (a few ulp)."""
    if img.dtype != torch.float32:
        raise TypeError(f"expected float32 images, got {img.dtype}")
    x, back = _as_hwc(img)
    _, h, w, c = x.shape
    dev = img.device

    def taps(src, dst):
        scale = 1.0 / (dst / src)
        f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f)
        coef = _cubic_coeffs((f - s).astype(np.float32))
        idx = np.clip(s.astype(np.int64)[:, None] - 1 + np.arange(4)[None],
                      0, src - 1)
        return torch.from_numpy(idx).to(dev), torch.from_numpy(coef).to(dev)

    ix, cx = taps(w, width)
    iy, cy = taps(h, height)
    hor = x[:, :, ix[:, 0]] * cx[:, 0, None]
    for k in (1, 2, 3):
        hor = hor + x[:, :, ix[:, k]] * cx[:, k, None]
    rows = [hor[:, iy[:, k]] for k in range(4)]
    beta = [cy[:, k, None, None] for k in range(4)]
    rev = rows[3] * beta[3]
    for k in (2, 1, 0):
        rev = rows[k] * beta[k] + rev
    fwd = rows[0] * beta[0]
    for k in (1, 2, 3):
        fwd = fwd + rows[k] * beta[k]
    n = width * c
    lanes = (torch.arange(n, device=dev)
             < n - n % _F32_LANES).reshape(width, c)
    return back(torch.where(lanes, rev, fwd))


def bgr_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_BGR2GRAY)`` for uint8 (..., H, W, 3):
    OpenCV's 15-bit fixed point, ``(3735 B + 19235 G + 9798 R + 2^14) >>
    15``."""
    if img.dtype != torch.uint8 or img.shape[-1] != 3:
        raise TypeError(f"expected uint8 (..., 3) BGR frames, got "
                        f"{img.dtype} {tuple(img.shape)}")
    x = img.to(torch.int32)
    b, g, r = _GRAY_COEFS
    return ((x[..., 0] * b + x[..., 1] * g + x[..., 2] * r
             + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).to(torch.uint8)
