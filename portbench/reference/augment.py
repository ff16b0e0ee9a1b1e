"""The training augmentation of the lane-segmentation reference, in plain
PyTorch float32, from its random draws.

The pipeline (albumentations in the original repository, the JAX
package's batched form of it, which the program follows):

  HueSaturationValue (cv2's uint8 HSV ranges: hue 0..179 wrapping,
  saturation and value clipped to 0..255) -> RandomSizedCrop (height drawn
  in [h/2, 4h], the output's aspect, clamped to the source, a uniform
  position; resampled bilinearly without antialiasing, labels by nearest
  neighbour) -> OneOf(MotionBlur over a bank of 24 line kernels, 3 sizes
  by 8 angles, or GaussNoise with variance in [10, 50]) -> clip to
  [0, 255] -> ImageNet normalisation.

``draws`` carries one row per sample: ``hsv`` (N, 3) in [-1, 1),
``crop_h`` (N,) int, ``h_start``, ``w_start`` (N,) in [0, 1),
``blur_idx`` (N,) in [0, 24), ``sigma2`` (N,), ``use_blur`` (N,) bool,
``noise`` (N, h, w, 3) standard normal.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

HUE, SAT, VAL = 20.0, 30.0, 20.0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _line_kernel(size: int, angle_idx: int, n_angles: int = 8) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    c = (size - 1) / 2
    theta = math.pi * angle_idx / n_angles
    for t in np.linspace(-c, c, 4 * size):
        x = int(round(c + t * math.cos(theta)))
        y = int(round(c + t * math.sin(theta)))
        if 0 <= x < size and 0 <= y < size:
            k[y, x] = 1.0
    k /= k.sum()
    pad = (7 - size) // 2
    return np.pad(k, ((pad, pad), (pad, pad)))


BLUR_BANK = np.stack([_line_kernel(s, a) for s in (3, 5, 7)
                      for a in range(8)])  # (24, 7, 7)


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    cs = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(v == r, 60.0 * (g - b) / cs,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / cs,
                                240.0 + 60.0 * (r - g) / cs))
    h = torch.where(c > 0, torch.remainder(h, 360.0), torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v))
                    * 255.0, torch.zeros_like(v))
    return h / 2.0, s, v


def _hsv_to_rgb(h, s, v):
    h, s = h * 2.0, s / 255.0
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    i = torch.remainder(torch.floor(hp).to(torch.int32), 6)
    table = ((c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c),
             (c, z, x))
    m = v - c
    out = []
    for ch in range(3):
        val = z
        for k in reversed(range(6)):
            val = torch.where(i == k, table[k][ch], val)
        out.append(val + m)
    return torch.stack(out, -1)


def shift_hsv(bgr_u8, hsv_draw):
    n = bgr_u8.shape[0]
    x = bgr_u8.to(torch.float32).flip(-1)
    h, s, v = _rgb_to_hsv(x)
    d = hsv_draw.to(torch.float32)
    h = torch.remainder(h + (d[:, 0] * HUE).view(n, 1, 1), 180.0)
    s = torch.clamp(s + (d[:, 1] * SAT).view(n, 1, 1), 0.0, 255.0)
    v = torch.clamp(v + (d[:, 2] * VAL).view(n, 1, 1), 0.0, 255.0)
    return torch.clamp(_hsv_to_rgb(h, s, v).flip(-1), 0.0, 255.0)


def _weights(in_size, out_size, scale, translation):
    """Triangle-kernel resampling weights without antialiasing
    (``jax.image.scale_and_translate``), (N, out, in)."""
    dev = scale.device
    inv = (1.0 / scale)[:, None]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (o + 0.5) * inv - translation[:, None] * inv - 0.5
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(sample[:, :, None] - i), min=0.0)
    total = w.sum(-1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def crop(img, labels, d, h, w):
    n, sh, sw, c = img.shape
    f32 = torch.float32
    w2h = torch.tensor(w / h, dtype=f32, device=img.device)
    ch = torch.clamp(d["crop_h"].to(f32), max=float(sh))
    cw = torch.clamp(torch.floor(ch * w2h), max=float(sw))
    y1 = torch.floor((sh - ch + 1.0) * d["h_start"].to(f32))
    x1 = torch.floor((sw - cw + 1.0) * d["w_start"].to(f32))
    sy, sx = h / ch, w / cw
    wy = _weights(sh, h, sy, -y1 * sy)
    wx = _weights(sw, w, sx, -x1 * sx)
    out = torch.einsum("nyi,nijc->nyjc", wy, img)
    out = torch.einsum("nxj,nyjc->nyxc", wx, out)
    oy = torch.arange(h, dtype=f32, device=img.device)
    ox = torch.arange(w, dtype=f32, device=img.device)
    iy = torch.round(y1[:, None] + (oy + 0.5) / sy[:, None] - 0.5)
    ix = torch.round(x1[:, None] + (ox + 0.5) / sx[:, None] - 0.5)
    iy = iy.to(torch.int64).clamp(0, sh - 1)
    ix = ix.to(torch.int64).clamp(0, sw - 1)
    rows = torch.arange(n, device=img.device)[:, None, None]
    return out, labels[rows, iy[:, :, None], ix[:, None, :]].to(torch.int64)


def normalize(x):
    mean = torch.tensor(MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    return (x / 255.0 - mean) / std


def augment(images_u8, labels, d: dict, h: int, w: int):
    """uint8 (N, H, W, 3) BGR frames and (N, H, W) labels -> normalised
    float32 (N, 3, h, w) and int64 (N, h, w) labels."""
    n = images_u8.shape[0]
    x = shift_hsv(images_u8, d["hsv"])
    x, y = crop(x, labels, d, h, w)
    bank = torch.from_numpy(BLUR_BANK).to(x.device)[d["blur_idx"]]
    # depthwise 'SAME' correlation: one 7x7 kernel per sample, all channels
    xc = x.permute(3, 0, 1, 2).reshape(1, 3 * n, h, w)
    k = bank.repeat(3, 1, 1).unsqueeze(1)
    blurred = F.conv2d(xc, k, padding=3, groups=3 * n)
    blurred = blurred.reshape(3, n, h, w).permute(1, 2, 3, 0)
    noisy = x + torch.sqrt(d["sigma2"].to(torch.float32)).view(n, 1, 1, 1) \
        * d["noise"].to(torch.float32)
    x = torch.clamp(torch.where(d["use_blur"].view(n, 1, 1, 1), blurred,
                                noisy), 0.0, 255.0)
    return normalize(x).permute(0, 3, 1, 2).contiguous(), y


def eval_input(images_u8):
    """uint8 (N, H, W, 3) frames at the model's size -> normalised
    float32 (N, 3, H, W)."""
    return normalize(images_u8.to(torch.float32)).permute(0, 3, 1, 2) \
        .contiguous()
