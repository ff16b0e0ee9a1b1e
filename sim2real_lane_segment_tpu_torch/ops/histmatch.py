"""Histogram matching (the HM regime) for uint8 frames on the card.

Counterpart of ``sim2real_lane_segment_tpu.ops.histmatch``: skimage's
``match_histograms`` per channel as a 256-entry lookup table, computed
with the JAX package's float32 arithmetic so that the two agree bit for
bit.  Per (image, channel): the source and template quantiles
``cumsum(counts) * float32(1 / size)`` (XLA's form of the division); for each value the last *present* template
value at or below it (leading absents take the first present one); then
``jnp.interp`` of the source quantiles on those (quantile, value) pairs,
its own formula (``searchsorted(side='right')`` clipped to [1, 255],
``fp[i-1] + (delta / dx) * df``, ``fp[i-1]`` where ``|dx|`` is at most
``spacing(eps)``, constant outside the template's range), rounded half to
even and clipped; the table then maps every pixel.  Where XLA:CPU fuses a
product into the next addition (``delta`` from the source quantile, and
the interpolant), the port rounds once too.

A batch's histograms are one ``bincount`` over ``(image * C + channel) *
256 + value``.
"""
from __future__ import annotations

import numpy as np
import torch

_BINS = 256
# jnp.interp's guard: np.spacing(np.finfo(float32).eps)
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _cumulative(images: torch.Tensor):
    """(N, H, W, C) uint8 -> float32 (N, C, 256) cumulative counts, the
    float32 reciprocal of H*W (their product is the quantiles), and the
    counts."""
    n, h, w, c = images.shape
    dev = images.device
    keys = (images.to(torch.int64)
            + (torch.arange(n * c, device=dev) * _BINS).reshape(n, 1, 1, c))
    counts = torch.bincount(keys.reshape(-1), minlength=n * c * _BINS)
    counts = counts.reshape(n, c, _BINS)
    cum = counts.cumsum(-1).to(torch.float32)
    inv = torch.tensor(np.float32(1) / np.float32(h * w), device=dev)
    return cum, inv, counts


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as the fused
    multiply-add XLA:CPU emits for them (the product of two float32 values
    is exact in float64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _luts(sources: torch.Tensor, references: torch.Tensor) -> torch.Tensor:
    """int64 (N, C, 256) tables mapping source values to matched ones."""
    src_cum, src_inv, _ = _cumulative(sources)
    tmpl_cum, tmpl_inv, tmpl_counts = _cumulative(references)
    src_q = src_cum * src_inv
    tmpl_q = tmpl_cum * tmpl_inv
    values = torch.arange(_BINS, device=sources.device)
    present = tmpl_counts > 0
    idx = torch.where(present, values, -1).cummax(-1).values
    first = (present.to(torch.int64).cumsum(-1) == 0).sum(-1, keepdim=True)
    idx = torch.where(idx < 0, first, idx)
    xp = tmpl_q.gather(-1, idx)
    fp = idx.to(torch.float32)

    lead = src_q.shape[:-1]
    i = torch.searchsorted(xp.reshape(-1, _BINS).contiguous(),
                           src_q.reshape(-1, _BINS).contiguous(),
                           right=True).reshape(*lead, _BINS)
    i = i.clamp(1, _BINS - 1)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = _fma(src_cum, src_inv, -xp0)
    dx0 = dx.abs() <= _DX_EPS
    f = torch.where(dx0, fp0,
                    _fma(delta / torch.where(dx0, torch.ones_like(dx), dx),
                         df, fp0))
    f = torch.where(src_q < xp[..., :1], fp[..., :1], f)
    f = torch.where(src_q > xp[..., -1:], fp[..., -1:], f)
    return torch.round(f).clamp(0, 255).to(torch.int64)


def match_histograms_batch(sources: torch.Tensor,
                           references: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 sources matched channel by channel to (N, h, w,
    C) uint8 references (sizes may differ), on the sources' device."""
    if sources.dtype != torch.uint8 or references.dtype != torch.uint8:
        raise TypeError("histogram matching takes uint8 images")
    n, h, w, c = sources.shape
    lut = _luts(sources, references)                      # (N, C, 256)
    flat = sources.to(torch.int64).permute(0, 3, 1, 2).reshape(n, c, h * w)
    out = lut.gather(-1, flat).reshape(n, c, h, w).permute(0, 2, 3, 1)
    return out.to(torch.uint8).contiguous()


def match_histograms(source: torch.Tensor,
                     reference: torch.Tensor) -> torch.Tensor:
    """One (H, W, C) uint8 image matched to an (h, w, C) reference."""
    return match_histograms_batch(source[None], reference[None])[0]
