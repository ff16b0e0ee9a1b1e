"""K5: label extraction from (original, annotated) frame pairs, on the
hand-written CUDA kernel of ``csrc/labelgen.cu``, with its plain PyTorch
version.

Counterpart of ``process_classes_fused`` in the JAX package's
``ops/labelgen_pallas.py``: the whole of ``process_classes`` (the diff,
the channel-sign rules, a 5x5 OPEN then CLOSE per class with cv2's
borders, the priority overwrite) in one launch.  The kernel holds each
class as a bit plane (32 pixels a word) and gives a block a strip of
``STRIP_ROWS`` rows of one image, with an 8-row halo, across a column tile
of at most 32 words; ``geometry`` states its launch geometry for the CPU
tests.  ``process_classes`` takes CPU tensors to
``process_classes_plain`` and CUDA tensors to the kernel; a failed build
or launch raises.  ``launches`` counts kernel launches (CUDA tensors
only).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.morphology import morph_close, morph_open
from . import build

launches = {"labelgen": 0}

# the kernel's strip (output rows a block), its halo (4 passes x radius 2)
# and the words a block holds per row (one per lane)
STRIP_ROWS = 32
HALO_ROWS = 8
LANES = 32


class Geometry(NamedTuple):
    """K5's launch at H x W: ``strips`` x ``tiles`` blocks per image, each
    ``strip_rows`` rows and ``core`` of the row's ``words`` 32-pixel words
    (plus a halo word on each inner side), ``smem`` bytes of shared memory
    (two buffers of 3 planes x (strip + 2 halo) rows x 32 words)."""
    strip_rows: int
    strips: int
    words: int
    tiles: int
    core: int
    smem: int


def geometry(h: int, w: int) -> Geometry:
    """The C library's launch geometry, stated for the CPU tests: one
    column tile while a row fits the 32 lanes, else tiles of at most 30
    core words, as even as they divide."""
    words = -(-w // 32)
    tiles = 1 if words <= LANES else -(-words // (LANES - 2))
    return Geometry(STRIP_ROWS, -(-h // STRIP_ROWS), words, tiles,
                    -(-words // tiles),
                    2 * 3 * (STRIP_ROWS + 2 * HALO_ROWS) * LANES * 4)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_pairs(img_orig: torch.Tensor, img_annot: torch.Tensor,
                 channel_order: str) -> None:
    if channel_order not in ("bgr", "rgb"):
        raise ValueError(f"bad channel_order {channel_order!r}")
    if img_orig.shape != img_annot.shape or img_orig.shape[-1:] != (3,):
        raise ValueError(f"frame pairs must be two (..., H, W, 3) tensors of "
                         f"one shape, got {tuple(img_orig.shape)} and "
                         f"{tuple(img_annot.shape)}")
    if img_orig.dtype != torch.uint8 or img_annot.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, got {img_orig.dtype} and "
                         f"{img_annot.dtype}")


def process_classes_plain(img_orig: torch.Tensor, img_annot: torch.Tensor,
                          channel_order: str = "bgr") -> torch.Tensor:
    """The label mask through PyTorch ops: uint8 (..., H, W)."""
    _check_pairs(img_orig, img_annot, channel_order)
    diff = img_annot.to(torch.int16) - img_orig.to(torch.int16)
    if channel_order == "bgr":
        b, g, r = diff[..., 0], diff[..., 1], diff[..., 2]
    else:
        r, g, b = diff[..., 0], diff[..., 1], diff[..., 2]
    left = b > 0
    right = g > 0
    obstacle = (r > 0) | ((r >= 0) & ((b < 0) | (g < 0)))
    left, right, obstacle = (morph_close(morph_open(m, 5), 5)
                             for m in (left, right, obstacle))
    out = torch.zeros(diff.shape[:-1], dtype=torch.uint8, device=diff.device)
    out[right] = 1
    out[left] = 2
    out[obstacle] = 3
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("labelgen")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.s2r_labelgen.argtypes = [p, p, i, i, i, i, p, p]
    lib.s2r_labelgen.restype = i
    lib.s2r_labelgen_geometry.argtypes = [i, i, ctypes.POINTER(i)]
    lib.s2r_labelgen_geometry.restype = None
    lib.s2r_labelgen_error_string.argtypes = [i]
    lib.s2r_labelgen_error_string.restype = ctypes.c_char_p
    return lib


def process_classes(img_orig: torch.Tensor, img_annot: torch.Tensor,
                    channel_order: str = "bgr") -> torch.Tensor:
    """uint8 (..., H, W, 3) pairs -> uint8 (..., H, W) masks with {0: bg,
    1: right lane, 2: left lane, 3: obstacle}."""
    if not img_orig.is_cuda:
        return process_classes_plain(img_orig, img_annot, channel_order)
    _check_pairs(img_orig, img_annot, channel_order)
    if img_annot.device != img_orig.device:
        raise ValueError(f"frames on {img_orig.device} and "
                         f"{img_annot.device}")
    *lead, h, w, _ = img_orig.shape
    orig = img_orig.reshape(-1, h, w, 3).contiguous()
    annot = img_annot.reshape(-1, h, w, 3).contiguous()
    out = torch.empty(orig.shape[:3], dtype=torch.uint8, device=orig.device)
    if out.numel() == 0:
        return out.reshape(*lead, h, w)
    lib = _lib()
    with build.on_device(orig.device):
        err = lib.s2r_labelgen(
            orig.data_ptr(), annot.data_ptr(), orig.shape[0], h, w,
            int(channel_order == "bgr"), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"labelgen launch failed: CUDA error {err} "
                           f"({lib.s2r_labelgen_error_string(err).decode()})")
    launches["labelgen"] += 1
    return out.reshape(*lead, h, w)
