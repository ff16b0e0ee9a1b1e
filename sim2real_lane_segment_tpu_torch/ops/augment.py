"""Input transforms of training and evaluation (the reference's
MyTransform).

Counterpart of ``sim2real_lane_segment_tpu.ops.augment``:

  train: HueSaturationValue -> RandomSizedCrop(min_max_height=(h/2, 4h),
         w2h locked) -> OneOf(MotionBlur, GaussNoise) -> [ToGray] ->
         Normalize (``augment_batch``)
  eval : Resize(h, w) -> [ToGray] -> Normalize (``eval_batch``)

The training pipeline runs batched on the images' device, with no loop
over samples.  Its random draws are tensors (``AugmentDraws``): the JAX
package derives them from a PRNG key, the port from a ``torch.Generator``
(``draw_augment``), and tests feed JAX's draws in to compare the two.
The random-sized crop is JAX's ``scale_and_translate`` (linear, no
antialiasing) written as one weight matrix per axis and sample, applied
by two batched float32 products; the label crop is a nearest gather.
The motion blur is a 49-tap weighted sum of shifted views, float32 on
every device (a cuDNN convolution could round it to TF32).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .colorspace import shift_hsv
from .resize import device_constant, normalize, normalize_flat, \
    resize_bilinear, resize_nearest_label, to_gray


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


# ---------------------------------------------------------------------------
# motion-blur kernel bank
# ---------------------------------------------------------------------------

def _line_kernel(size: int, angle_idx: int, n_angles: int = 8) -> np.ndarray:
    """A normalized line kernel through the center, padded to 7x7."""
    k = np.zeros((size, size), np.float32)
    c = (size - 1) / 2
    theta = np.pi * angle_idx / n_angles
    dx, dy = np.cos(theta), np.sin(theta)
    for t in np.linspace(-c, c, 4 * size):
        x = int(round(c + t * dx))
        y = int(round(c + t * dy))
        if 0 <= x < size and 0 <= y < size:
            k[y, x] = 1.0
    k /= k.sum()
    pad = (7 - size) // 2
    return np.pad(k, ((pad, pad), (pad, pad)))


_MB_SIZES = (3, 5, 7)
_MB_ANGLES = 8
MOTION_BLUR_BANK = np.stack([
    _line_kernel(s, a) for s in _MB_SIZES for a in range(_MB_ANGLES)
])  # (24, 7, 7) float32


@functools.cache
def _blur_bank(device: torch.device) -> torch.Tensor:
    """``MOTION_BLUR_BANK`` on ``device``, uploaded once per device."""
    with torch.inference_mode(False):
        return torch.from_numpy(MOTION_BLUR_BANK).to(device)


def motion_blur(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 "SAME" correlation of (N, H, W, C) images, each with
    its own (7, 7) kernel from ``kernels`` (N, 7, 7), in float32."""
    n, h, w, _ = images.shape
    pad = F.pad(images.to(torch.float32), (0, 0, 3, 3, 3, 3))
    k = kernels.to(torch.float32)
    out = torch.zeros_like(pad[:, :h, :w])
    for i in range(7):
        for j in range(7):
            out.addcmul_(k[:, i, j].view(n, 1, 1, 1), pad[:, i:i + h, j:j + w])
    return out


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------

class AugmentDraws(NamedTuple):
    """One batch's random draws, one row per sample."""
    hsv: torch.Tensor        # (N, 3) float32 in [-1, 1): hue, sat, val
    crop_h: torch.Tensor     # (N,) int64 in [min_crop_height, max]
    h_start: torch.Tensor    # (N,) float32 in [0, 1)
    w_start: torch.Tensor    # (N,) float32 in [0, 1)
    blur_idx: torch.Tensor   # (N,) int64 in [0, 24)
    sigma2: torch.Tensor     # (N,) float32 noise variance
    use_blur: torch.Tensor   # (N,) bool: blur, else noise
    noise: torch.Tensor      # (N, height, width, 3) float32 standard normal

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device) for t in self))


def draw_augment(generator: torch.Generator, n: int, cfg: AugmentConfig,
                 device) -> AugmentDraws:
    """Draws for ``n`` samples.  One 63-bit seed is taken from
    ``generator``; every draw comes from a generator on ``device`` seeded
    with it, so the noise is made where it is used."""
    device = torch.device(device)
    seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                             device=generator.device))
    g = torch.Generator(device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    lo, hi = cfg.noise_var_min, cfg.noise_var_max
    return AugmentDraws(
        hsv=torch.rand(n, 3, **kw) * 2.0 - 1.0,
        crop_h=torch.randint(cfg.min_crop_height, cfg.max_crop_height + 1,
                             (n,), **kw),
        h_start=torch.rand(n, **kw),
        w_start=torch.rand(n, **kw),
        blur_idx=torch.randint(0, len(MOTION_BLUR_BANK), (n,), **kw),
        sigma2=torch.rand(n, **kw) * (hi - lo) + lo,
        use_blur=torch.rand(n, **kw) < 0.5,
        noise=torch.randn(n, cfg.height, cfg.width, 3, **kw))


# ---------------------------------------------------------------------------
# random-sized crop
# ---------------------------------------------------------------------------

def crop_boxes(draws: AugmentDraws, src_h: int, src_w: int,
               cfg: AugmentConfig):
    """(crop_h, crop_w, y1, x1) float32 per sample, in JAX's float32 order.

    albumentations semantics (reference myTransforms.py:10-11): the crop's
    aspect is the output's; crops larger than the source are clamped to
    it; the position is uniform."""
    f32 = torch.float32
    w2h = device_constant(cfg.width / cfg.height, draws.crop_h.device)
    crop_h = torch.clamp(draws.crop_h.to(f32), max=float(src_h))
    crop_w = torch.clamp(torch.floor(crop_h * w2h), max=float(src_w))
    y1 = torch.floor((src_h - crop_h + 1.0) * draws.h_start.to(f32))
    x1 = torch.floor((src_w - crop_w + 1.0) * draws.w_start.to(f32))
    return crop_h, crop_w, y1, x1


def _linear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """(N, out_size, in_size) weights of ``jax.image.scale_and_translate``
    with the triangle kernel and no antialiasing, per sample."""
    dev = scale.device
    inv = (1.0 / scale)[:, None]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (o + 0.5) * inv - translation[:, None] * inv - 0.5
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(sample[:, :, None] - i), min=0.0)
    total = w.sum(-1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def random_sized_crop(images: torch.Tensor, labels: torch.Tensor | None,
                      draws: AugmentDraws, cfg: AugmentConfig):
    """Crop every (N, H, W, 3) float image to its box and resample it to
    (height, width) bilinearly; labels (N, H, W) by nearest neighbour."""
    n, src_h, src_w, c = images.shape
    crop_h, crop_w, y1, x1 = crop_boxes(draws, src_h, src_w, cfg)
    scale_y = cfg.height / crop_h
    scale_x = cfg.width / crop_w
    wy = _linear_weights(src_h, cfg.height, scale_y, -y1 * scale_y)
    wx = _linear_weights(src_w, cfg.width, scale_x, -x1 * scale_x)
    img = images.to(torch.float32)
    rows = torch.bmm(wy, img.reshape(n, src_h, src_w * c))  # (N, h, W*c)
    rows = rows.view(n, cfg.height, src_w, c).permute(0, 2, 1, 3)
    out = torch.bmm(wx, rows.reshape(n, src_w, cfg.height * c))
    out = out.view(n, cfg.width, cfg.height, c).permute(0, 2, 1, 3)
    if labels is None:
        return out.contiguous(), None
    dev = images.device
    oy = torch.arange(cfg.height, dtype=torch.float32, device=dev)
    ox = torch.arange(cfg.width, dtype=torch.float32, device=dev)
    sy = torch.round(y1[:, None] + (oy + 0.5) / scale_y[:, None] - 0.5)
    sx = torch.round(x1[:, None] + (ox + 0.5) / scale_x[:, None] - 0.5)
    sy = sy.to(torch.int64).clamp(0, src_h - 1)
    sx = sx.to(torch.int64).clamp(0, src_w - 1)
    rows_idx = torch.arange(n, device=dev)[:, None, None]
    y = labels[rows_idx, sy[:, :, None], sx[:, None, :]]
    return out.contiguous(), y.to(torch.int32)


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def augment_batch(images: torch.Tensor, labels: torch.Tensor | None,
                  cfg: AugmentConfig, draws: AugmentDraws,
                  with_labels: bool = True):
    """Train-time augmentation of a uint8 (N, H, W, 3) batch, on its
    device, in the JAX order: HSV at the source size, the crop resample to
    (height, width), blur or noise, clip to [0, 255], [gray], normalize.

    Returns float32 (N, height, width, 3) and int32 labels (or None)."""
    n = images.shape[0]
    hsv = draws.hsv.to(torch.float32)

    def per_sample(v):
        return v.view(n, 1, 1)

    x = shift_hsv(images, per_sample(hsv[:, 0] * cfg.hue_limit),
                  per_sample(hsv[:, 1] * cfg.sat_limit),
                  per_sample(hsv[:, 2] * cfg.val_limit), cfg.channel_order)
    x, y = random_sized_crop(x, labels if with_labels else None, draws, cfg)
    bank = _blur_bank(x.device)
    blurred = motion_blur(x, bank[draws.blur_idx])
    sigma = torch.sqrt(draws.sigma2.to(torch.float32)).view(n, 1, 1, 1)
    noisy = x + sigma * draws.noise.to(torch.float32)
    x = torch.clamp(torch.where(draws.use_blur.view(n, 1, 1, 1), blurred,
                                noisy), 0.0, 255.0)
    if cfg.gray:
        x = to_gray(x, cfg.channel_order)
    return normalize(x), y


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
