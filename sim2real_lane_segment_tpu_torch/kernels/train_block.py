"""K1, K2, K3a and K3b: the FC-DenseNet train-mode consumer layers, on the
hand-written CUDA kernels of ``csrc/train_block.cu``, with their plain
PyTorch versions.

Counterparts of ``_consumer_fwd``, ``_consumer_bwd_call``, ``_stage_call``
and ``_final_call`` in the JAX package's ``models/tiramisu_train_pallas.py``.
Tensors are NCHW.  A consumer reads channels ``[0, c)`` of ``x`` (``c =
weight.shape[0]``), which may be a channel slice of a larger buffer: only
the batch stride is free.  Weights are ``[c, taps, n]`` in the compute
dtype (tap = ky*3 + kx; taps 9 for a DenseLayer, 1 for TransitionDown),
BN ``scale``/``shift`` and ``bias`` f32, dropout ``mask`` f32 ``[B, n]``
(already scaled by 1/(1-rate)).  With ``a = T(relu(x*scale + shift))``
(zero padding applies to ``a``) and ``G = T(dy*mask)``:

- ``consumer_fwd`` (K1): ``T((conv(a, W) + bias) * mask)``;
- ``consumer_bwd`` (K2): ``dseg = T(dz*scale)``, ``dscale = sum dz*x``,
  ``dshift = sum dz``, ``dW = sum G (x) a`` (f32), ``dbias = sum dy*mask``,
  where ``dz = (W^T-correlation of G) * relu'(z)``;
- ``stage`` (K3a): one stage of the fused reverse sweep over a dense
  block: ``dy_j = ext + sum_l dA_l * relu'(z_l) * scale_l`` rebuilt from
  the later layers' stored ``g_pre``, then ``g_pre_j = T(dy_j*mask)`` and
  the K2 sums (no ``dseg``);
- ``final`` (K3b): the block-input cotangent ``T(sum_l dA_l * relu'(z_l) *
  scale_l)`` over all of the block's layers.

``relu'(z) = (z > 0) + 0.5 (z == 0)``: the tie rule of ``jnp.maximum``.
In bfloat16, K1 (3x3 with 12 or 16 outputs, or one tap), K2 with one tap,
and K3a and K3b with 12 or 16 outputs run on the tensor cores
(``takes_mma_fwd``, ``takes_mma_bwd``, ``takes_mma_stage``): every site of
FCDenseNet57, 67 and 103 but FCDenseNet103's last TransitionDown
backward (656 outputs).  Float32 and the other shapes run on the CUDA
cores.  The tensor-core 3x3 kernels read their weights (K1's ``weight``,
K3a's ``weight`` and ``w_slices``, K3b's ``w_slices``) in the layout of
``dense_block.pad_growth``: [c, 9, g] views of rows padded to 16 columns
with zeros, which ``models/tiramisu_train_fused.conv_weight_rows`` makes
in the per-step re-layout; their wrappers refuse any other layout there.
The plain versions take either layout and read the [c, 9, g] view; K2
takes contiguous weights.
Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; a failed build or launch raises.  ``launches`` counts wrapper
calls that launched a kernel (CUDA tensors only), ``mma_launches`` those
of them that took the tensor-core route, as the C entry reports it through
its ``route`` argument.  A wrapper called while a CUDA graph is captured
counts once, at the capture: a replay runs no Python.  The library sets
its kernels' shared-memory limits when it loads, so a launch records
kernels only and can be captured.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from . import build
from .dense_block import MMA_WIDTH, mma_layout

launches = {"consumer_fwd": 0, "consumer_bwd": 0, "stage": 0, "final": 0}

TILE = 16        # the kernels' pixel tile and channel group
MAX_LAYERS = 16  # layers one stage or final launch may read


mma_launches = {"consumer_fwd": 0, "consumer_bwd": 0, "stage": 0, "final": 0}


def reset_launches() -> None:
    for counts in (launches, mma_launches):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def relu_grad(z: torch.Tensor) -> torch.Tensor:
    """d relu / dz with the tie at z == 0 split evenly (0.5)."""
    return (z > 0).to(torch.float32) + 0.5 * (z == 0).to(torch.float32)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def _act(x: torch.Tensor, scale, shift):
    """z = x*scale + shift (f32) and the conv operand T(relu(z)) as f32."""
    z = x.to(torch.float32) * _col(scale) + _col(shift)
    return z, torch.relu(z).to(x.dtype).to(torch.float32)


def conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """[c, taps, n] -> the f32 conv weight [n, c, k, k]."""
    c, taps, n = weight.shape
    k = 3 if taps == 9 else 1
    return weight.to(torch.float32).reshape(c, k, k, n).permute(3, 0, 1, 2)


def _pad(taps: int) -> int:
    return 1 if taps == 9 else 0


def consumer_fwd_plain(x, scale, shift, weight, bias, mask, out=None):
    c, taps, _ = weight.shape
    _, a = _act(x[:, :c], scale, shift)
    y = F.conv2d(a, conv_weight(weight), padding=_pad(taps))
    y = ((y + _col(bias)) * mask[:, :, None, None]).to(x.dtype)
    if out is None:
        return y
    out.copy_(y)
    return out


def _own_layer_plain(x, scale, shift, weight, g):
    """(dz, dW, dscale, dshift) of one layer from its input and rounded G."""
    c, taps, n = weight.shape
    z, a = _act(x, scale, shift)
    w4 = conv_weight(weight)
    dw = torch.nn.grad.conv2d_weight(a, w4.shape, g, padding=_pad(taps))
    dw = dw.permute(1, 2, 3, 0).reshape(c, taps, n)
    dz = F.conv_transpose2d(g, w4, padding=_pad(taps)) * relu_grad(z)
    xf = x.to(torch.float32)
    return dz, dw, (dz * xf).sum((0, 2, 3)), dz.sum((0, 2, 3))


def consumer_bwd_plain(x, scale, shift, weight, mask, dy):
    x = x[:, :weight.shape[0]]
    gp = dy.to(torch.float32) * mask[:, :, None, None]
    g = gp.to(x.dtype).to(torch.float32)
    dz, dw, dscale, dshift = _own_layer_plain(x, scale, shift, weight, g)
    dseg = (dz * _col(scale)).to(x.dtype)
    return dseg, dscale, dshift, dw, gp.sum((0, 2, 3))


def _later_terms(acc, xv, gps, w_slices, sc_slices, sh_slices):
    """acc + sum_l dA_l * relu'(z_l) * scale_l (acc None: start at 0)."""
    for gp, w, sc, sh in zip(gps, w_slices, sc_slices, sh_slices):
        da = F.conv_transpose2d(gp.to(torch.float32), conv_weight(w),
                                padding=1)
        z = xv * _col(sc) + _col(sh)
        t = da * relu_grad(z) * _col(sc)
        acc = t if acc is None else acc + t
    return acc


def stage_plain(x, y, ext, gps, w_slices, scale, shift, sc_slices, sh_slices,
                weight, mask):
    x = x[:, :weight.shape[0]]
    dy = _later_terms(ext.to(torch.float32), y.to(torch.float32), gps,
                      w_slices, sc_slices, sh_slices)
    gpre = dy * mask[:, :, None, None]
    gp = gpre.to(x.dtype)
    _, dw, dscale, dshift = _own_layer_plain(x, scale, shift, weight,
                                             gp.to(torch.float32))
    return gp, dw, dscale, dshift, gpre.sum((0, 2, 3))


def final_plain(x, gps, w_slices, sc_slices, sh_slices):
    c = w_slices[0].shape[0]
    acc = _later_terms(None, x[:, :c].to(torch.float32), gps, w_slices,
                       sc_slices, sh_slices)
    return acc.to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built once)."""
    lib = build.load("train_block")
    lib.s2r_train_fwd.argtypes = [_I, _I, _P, _L, _I, _I, _I, _I, _P, _P, _P,
                                  _P, _P, _I, _P, _L, _IP, _P]
    lib.s2r_train_bwd.argtypes = ([_I, _I, _P, _L, _I, _I, _I, _I, _P, _P, _P,
                                   _P, _I, _P] + [_P] * 9 + [_I, _IP, _P])
    lib.s2r_train_stage.argtypes = ([_I, _P, _L, _I, _I, _I, _I, _P, _L, _I,
                                     _P, _I, _PP, _PP, _PP, _PP]
                                    + [_P] * 12 + [_I, _IP, _P])
    lib.s2r_train_final.argtypes = [_I, _P, _L, _I, _I, _I, _I, _I, _I, _PP,
                                    _PP, _PP, _PP, _P, _IP, _P]
    for fn in (lib.s2r_train_fwd, lib.s2r_train_bwd, lib.s2r_train_stage,
               lib.s2r_train_final, lib.s2r_train_init):
        fn.restype = _I
    lib.s2r_train_init.argtypes = []
    lib.s2r_train_error_string.argtypes = [_I]
    lib.s2r_train_error_string.restype = ctypes.c_char_p
    # the kernels' shared-memory limits, set here so that no launch (and
    # no CUDA-graph capture) meets an attribute call
    _check(lib, lib.s2r_train_init(), "train_block init")
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.s2r_train_error_string(err).decode()})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_view(t: torch.Tensor, channels: int, name: str) -> None:
    """A CUDA [B, >=channels, H, W] tensor in a kernel dtype whose channel,
    row and column strides are those of a contiguous tensor."""
    _require(t.is_cuda, f"{name} must be a CUDA tensor")
    _require(t.dtype in _DTYPE_CODE,
             f"{name} dtype {t.dtype} is not float32 or bfloat16")
    _require(t.dim() == 4, f"{name} must be [B, C, H, W]")
    _, c, h, w = t.shape
    _require(c >= channels, f"{name} has {c} channels, {channels} are read")
    _require(t.stride(3) == 1 and t.stride(2) == w and t.stride(1) == h * w,
             f"{name}: only the batch stride may differ from contiguous")


def _check_operand(t: torch.Tensor, ref: torch.Tensor, dtype, shape,
                   name: str, padded: bool = False) -> None:
    """``padded``: the ``pad_growth`` layout instead of contiguous."""
    layout = mma_layout(t) if padded else t.is_contiguous()
    if not (t.device == ref.device and t.dtype == dtype
            and t.shape == shape and layout):
        want = (f"rows padded to {MMA_WIDTH} columns (pad_growth)" if padded
                else "contiguous")
        raise ValueError(
            f"{name}: expected {want} {dtype} {tuple(shape)} on "
            f"{ref.device}, got {t.dtype} {tuple(t.shape)} strides "
            f"{t.stride()} on {t.device}")


def n_tiles(h: int, w: int) -> int:
    return math.ceil(h / TILE) * math.ceil(w / TILE)


def wgrad_splits(c: int, n: int, b: int, h: int, w: int) -> int:
    """How many partial sums the weight cotangent is split into: enough
    blocks to fill the card, at most one split per (image, tile) item."""
    groups = math.ceil(c / TILE) * math.ceil(n / TILE)
    return max(1, min(b * n_tiles(h, w), math.ceil(1024 / groups), 64))


# K2 in bf16 with one tap runs on the tensor cores (bwd1x1_mma in
# csrc/train_block.cu): 128-pixel tiles, 128x128 weight-cotangent tiles,
# up to 624 outputs
MMA_TILE, MMA_MAX_N = 128, 624


def takes_mma_bwd(dtype: torch.dtype, taps: int, n: int) -> bool:
    """Whether ``consumer_bwd`` launches the tensor-core 1x1 backward (the
    C side dispatches by the same rule)."""
    return dtype == torch.bfloat16 and taps == 1 and n <= MMA_MAX_N


def mma_wgrad_splits(c: int, n: int, b: int, h: int, w: int) -> int:
    """Pixel-range splits of the tensor-core weight cotangent: two blocks
    per SM of an H100 (264), at most one split per 128-pixel slice."""
    tiles = math.ceil(c / MMA_TILE) * math.ceil(n / MMA_TILE)
    items = b * math.ceil(h * w / MMA_TILE)
    return max(1, min(items, math.ceil(264 / tiles)))


# K1, K3a and K3b in bf16 run on the tensor cores (fwd3x3_mma_kernel,
# sum_dgrad_mma_kernel, stage_own_mma_kernel in csrc/train_block.cu; K1
# with one tap through csrc/td_fwd_mma.cuh): 12x16 pixel tiles, growth 12
# or 16 (FCDenseNet57's; 67's and 103's), own-layer chunks of up to 64
# channels
MMA3_TILE_H, MMA3_TILE_W, MMA3_CHUNK = 12, 16, 64
MMA3_GROWTHS = (12, 16)
MMA_FWD1_MAX_C = 768   # one tap: the x tile must fit in shared memory


def takes_mma_fwd(dtype: torch.dtype, taps: int, c: int, n: int) -> bool:
    """Whether ``consumer_fwd`` launches a tensor-core kernel (the C side
    dispatches by the same rule)."""
    if dtype != torch.bfloat16:
        return False
    return n in MMA3_GROWTHS if taps == 9 else c <= MMA_FWD1_MAX_C


def takes_mma_stage(dtype: torch.dtype, g: int) -> bool:
    """Whether ``stage`` and ``final`` launch the tensor-core kernels (the
    C side dispatches by the same rule)."""
    return dtype == torch.bfloat16 and g in MMA3_GROWTHS


def mma3_tiles(h: int, w: int) -> int:
    return math.ceil(h / MMA3_TILE_H) * math.ceil(w / MMA3_TILE_W)


def mma_stage_chunks(c: int) -> tuple[int, int]:
    """(chunks, 16-channel units per chunk) of the own-layer kernel: as few
    chunks of at most 64 channels as cover ``c``, evenly sized."""
    n16 = math.ceil(c / 16)
    chunks = math.ceil(n16 / (MMA3_CHUNK // 16))
    units = math.ceil(n16 / chunks)
    return math.ceil(n16 / units), units


def mma_stage_splits(c: int, b: int, h: int, w: int) -> int:
    """Item-range splits of the own-layer kernel: two blocks per SM of an
    H100 (264) over its channel chunks, at most one split per (image,
    tile) item."""
    chunks, _ = mma_stage_chunks(c)
    return max(1, min(b * mma3_tiles(h, w), 264 // chunks))


def _stream() -> int:
    """The current stream, inside ``build.on_device`` of the operands."""
    return torch.cuda.current_stream().cuda_stream


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * max(1, len(ts)))(*[t.data_ptr() for t in ts])


def consumer_fwd(x: torch.Tensor, scale, shift, weight, bias, mask,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K1.  Returns ``out`` (written in place; a [B, n, H, W] view whose
    batch stride may differ) or a new [B, n, H, W] tensor.  ``weight``: in
    the ``pad_growth`` layout where ``takes_mma_fwd`` with 9 taps, else
    contiguous."""
    if not x.is_cuda:
        return consumer_fwd_plain(x, scale, shift, weight, bias, mask, out)
    c, taps, n = weight.shape
    _check_view(x, c, "consumer input")
    b, _, h, w = x.shape
    _check_operand(scale, x, torch.float32, (c,), "scale")
    _check_operand(shift, x, torch.float32, (c,), "shift")
    _check_operand(weight, x, x.dtype, (c, taps, n), "weight",
                   taps == 9 and takes_mma_fwd(x.dtype, taps, c, n))
    _check_operand(bias, x, torch.float32, (n,), "bias")
    _check_operand(mask, x, torch.float32, (b, n), "mask")
    _require(taps in (1, 9), f"taps {taps} is not 1 or 9")
    if out is None:
        out = _empty((b, n, h, w), x.dtype, x)
    _check_view(out, n, "consumer output")
    _require(out.dtype == x.dtype and tuple(out.shape) == (b, n, h, w),
             "consumer output shape or dtype")
    lib = _lib()
    route = _I(0)
    with build.on_device(x.device):
        err = lib.s2r_train_fwd(
            _DTYPE_CODE[x.dtype], taps, x.data_ptr(), x.stride(0), b, c, h,
            w, scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), mask.data_ptr(), n, out.data_ptr(),
            out.stride(0), ctypes.byref(route), _stream())
    _check(lib, err, "consumer_fwd")
    launches["consumer_fwd"] += 1
    mma_launches["consumer_fwd"] += route.value
    return out


def consumer_bwd(x: torch.Tensor, scale, shift, weight, mask, dy):
    """K2.  Returns (dseg [B, c, H, W], dscale [c], dshift [c], dW [c, taps,
    n] f32, dbias [n])."""
    if not x.is_cuda:
        return consumer_bwd_plain(x, scale, shift, weight, mask, dy)
    c, taps, n = weight.shape
    _check_view(x, c, "consumer input")
    b, _, h, w = x.shape
    _check_operand(scale, x, torch.float32, (c,), "scale")
    _check_operand(shift, x, torch.float32, (c,), "shift")
    _check_operand(weight, x, x.dtype, (c, taps, n), "weight")
    _check_operand(mask, x, torch.float32, (b, n), "mask")
    _check_operand(dy, x, x.dtype, (b, n, h, w), "dy")
    _require(taps in (1, 9), f"taps {taps} is not 1 or 9")
    f32 = torch.float32
    dseg = _empty((b, c, h, w), x.dtype, x)
    gbuf = _empty((b, n, h, w), x.dtype, x)
    # the four f32 results share one allocation and the partial sums
    # another: each torch.empty costs microseconds of host time per step
    res = _empty((2 * c + c * taps * n + n,), f32, x)
    dscale, dshift, dw, dbias = res.split((c, c, c * taps * n, n))
    dw = dw.view(c, taps, n)
    if takes_mma_bwd(x.dtype, taps, n):
        rows = b * math.ceil(h * w / MMA_TILE)
        splits = mma_wgrad_splits(c, n, b, h, w)
        sizes = (rows * n, 2 * rows * c, splits * c * n)
    else:
        splits = wgrad_splits(c, n, b, h, w)
        sizes = (b * n, 2 * b * n_tiles(h, w) * c, splits * c * taps * n)
    part_gp, part_ss, part_w = _empty((sum(sizes),), f32, x).split(sizes)
    lib = _lib()
    route = _I(0)
    with build.on_device(x.device):
        err = lib.s2r_train_bwd(
            _DTYPE_CODE[x.dtype], taps, x.data_ptr(), x.stride(0), b, c, h,
            w, scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
            mask.data_ptr(), n, dy.data_ptr(), dseg.data_ptr(),
            dscale.data_ptr(), dshift.data_ptr(), dw.data_ptr(),
            dbias.data_ptr(), gbuf.data_ptr(), part_gp.data_ptr(),
            part_ss.data_ptr(), part_w.data_ptr(), splits,
            ctypes.byref(route), _stream())
    _check(lib, err, "consumer_bwd")
    launches["consumer_bwd"] += 1
    mma_launches["consumer_bwd"] += route.value
    return dseg, dscale, dshift, dw, dbias


def _check_later(x, gps, w_slices, sc_slices, sh_slices, rows, g, padded):
    b, _, h, w = x.shape
    _require(len(gps) == len(w_slices) == len(sc_slices) == len(sh_slices)
             <= MAX_LAYERS, f"at most {MAX_LAYERS} layers, equal counts")
    for i, (gp, wl, sc, sh) in enumerate(zip(gps, w_slices, sc_slices,
                                             sh_slices)):
        _check_operand(gp, x, x.dtype, (b, g, h, w), f"g_pre {i}")
        _check_operand(wl, x, x.dtype, (rows, 9, g), f"weight rows {i}",
                       padded)
        _check_operand(sc, x, torch.float32, (rows,), f"scale rows {i}")
        _check_operand(sh, x, torch.float32, (rows,), f"shift rows {i}")


def stage(x: torch.Tensor, y: torch.Tensor, ext: torch.Tensor,
          gps: Sequence[torch.Tensor], w_slices: Sequence[torch.Tensor],
          scale, shift, sc_slices, sh_slices, weight, mask):
    """K3a for layer j.  ``x``: its input (channels [0, c_j)); ``y``: its
    output [B, g, H, W]; ``ext``: f32 cotangent of ``y`` from outside the
    block; per later layer l: ``gps[l]`` its stored g_pre, ``w_slices[l]``
    the y_j rows of its weight [g, 9, g] and its BN scale/shift on them.
    Where ``takes_mma_stage``, ``weight`` and ``w_slices`` are in the
    ``pad_growth`` layout (slices of it), else contiguous.  Returns
    (g_pre_j [B, g, H, W], dW [c_j, 9, g] f32 (contiguous, unpadded),
    dscale, dshift, dbias)."""
    if not x.is_cuda:
        return stage_plain(x, y, ext, gps, w_slices, scale, shift, sc_slices,
                           sh_slices, weight, mask)
    c, taps, g = weight.shape
    _require(taps == 9, "stage takes 3x3 dense layers")
    _check_view(x, c, "stage input")
    b, _, h, w = x.shape
    _check_view(y, g, "stage output")
    _require(y.dtype == x.dtype and tuple(y.shape) == (b, g, h, w),
             "stage output shape or dtype")
    _check_operand(ext, x, torch.float32, (b, g, h, w), "ext")
    _check_operand(scale, x, torch.float32, (c,), "scale")
    _check_operand(shift, x, torch.float32, (c,), "shift")
    mma = takes_mma_stage(x.dtype, g)
    _check_operand(weight, x, x.dtype, (c, 9, g), "weight", mma)
    _check_operand(mask, x, torch.float32, (b, g), "mask")
    _check_later(x, gps, w_slices, sc_slices, sh_slices, g, g, mma)
    f32 = torch.float32
    gp = _empty((b, g, h, w), x.dtype, x)
    # the four f32 results share one allocation (dW, dscale, dshift, dbias
    # in the order the tensor-core reduce writes them) and the partial sums
    # another: each torch.empty costs microseconds of host time per stage
    dw, dscale, dshift, dbias = _empty((c * 9 * g + 2 * c + g,), f32,
                                       x).split((c * 9 * g, c, c, g))
    dw = dw.view(c, 9, g)
    if mma:
        splits = mma_stage_splits(c, b, h, w)
        sizes = (g * b * mma3_tiles(h, w), 0, splits * c * (9 * g + 2))
    else:
        splits = wgrad_splits(c, g, b, h, w)
        sizes = (b * n_tiles(h, w) * g, 2 * b * n_tiles(h, w) * c,
                 splits * c * 9 * g)
    part_gp, part_ss, part_w = _empty((sum(sizes),), f32, x).split(sizes)
    lib = _lib()
    route = _I(0)
    with build.on_device(x.device):
        err = lib.s2r_train_stage(
            _DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), b, c, h, w,
            y.data_ptr(), y.stride(0), g, ext.data_ptr(), len(gps),
            ctypes.cast(_ptrs(gps), _PP), ctypes.cast(_ptrs(w_slices), _PP),
            ctypes.cast(_ptrs(sc_slices), _PP),
            ctypes.cast(_ptrs(sh_slices), _PP), weight.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), mask.data_ptr(),
            gp.data_ptr(), dw.data_ptr(), dscale.data_ptr(),
            dshift.data_ptr(), dbias.data_ptr(), part_gp.data_ptr(),
            part_ss.data_ptr(), part_w.data_ptr(), splits,
            ctypes.byref(route), _stream())
    _check(lib, err, "stage")
    launches["stage"] += 1
    mma_launches["stage"] += route.value
    return gp, dw, dscale, dshift, dbias


def final(x: torch.Tensor, gps: Sequence[torch.Tensor],
          w_slices: Sequence[torch.Tensor], sc_slices, sh_slices):
    """K3b: the cotangent of a block's input channels [0, c_in) (``c_in =
    w_slices[0].shape[0]``) from all of its layers' stored g_pre.  Where
    ``takes_mma_stage``, ``w_slices`` are slices of the ``pad_growth``
    layout, else contiguous."""
    if not x.is_cuda:
        return final_plain(x, gps, w_slices, sc_slices, sh_slices)
    _require(len(gps) >= 1, "final needs at least one layer")
    c, _, g = w_slices[0].shape
    _check_view(x, c, "block input")
    b, _, h, w = x.shape
    _check_later(x, gps, w_slices, sc_slices, sh_slices, c, g,
                 takes_mma_stage(x.dtype, g))
    dseg = _empty((b, c, h, w), x.dtype, x)
    lib = _lib()
    route = _I(0)
    with build.on_device(x.device):
        err = lib.s2r_train_final(
            _DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), b, c, h, w, g,
            len(gps), ctypes.cast(_ptrs(gps), _PP),
            ctypes.cast(_ptrs(w_slices), _PP),
            ctypes.cast(_ptrs(sc_slices), _PP),
            ctypes.cast(_ptrs(sh_slices), _PP), dseg.data_ptr(),
            ctypes.byref(route), _stream())
    _check(lib, err, "final")
    launches["final"] += 1
    mma_launches["final"] += route.value
    return dseg
