"""K4: the FC-DenseNet inference dense block, on the hand-written CUDA
kernels of ``csrc/dense_block.cu``, with their plain PyTorch versions.

Counterpart of ``fused_dense_block_cm`` in the JAX package's
``models/tiramisu_pallas.py``.  A block allocates one feature buffer
``[B, c_total, H, W]`` in the compute dtype, copies its input segments
into the first channels (the virtual concat) and runs three entry points:

- ``dense_layer``: per layer, ``relu(F[:c_j]*scale+shift)`` rounded to the
  compute dtype, zero-padded 3x3 conv summed in f32, ``+bias`` in f32,
  rounded, written to ``F[c_j:c_j+g]`` in place;
- ``transition``: the TransitionDown pre-pool output, the same product
  with one tap and ``c_total`` outputs, rounded as ``T(T(sum) + T(bias))``;
- ``classifier``: per-pixel L2 norm in f32, ``F/norm`` rounded, 1x1 conv
  to 8 (padded) rows in f32, ``(. + b) * (1/temperature)``, f32 logits.

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; a failed build or launch raises.  ``launches`` counts kernel
launches per entry point (CUDA tensors only).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import build

launches = {"dense_layer": 0, "transition": 0, "classifier": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class FoldedLayer(NamedTuple):
    """One DenseLayer with its BatchNorm folded: ``scale``/``shift`` [c_j]
    f32, ``weight`` [c_j, 9, g] in the compute dtype (tap = ky*3+kx),
    ``bias`` [g] f32."""
    scale: torch.Tensor
    shift: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor


class FoldedTransition(NamedTuple):
    """TransitionDown before the pool: ``scale``/``shift`` [C] f32,
    ``weight`` [C_in, C_out] in the compute dtype, ``bias`` [C_out] f32."""
    scale: torch.Tensor
    shift: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor


class FoldedClassifier(NamedTuple):
    """Classifier tail: ``weight`` [8, C] in the compute dtype (rows past
    n_classes are zero), ``bias`` [8] f32, ``inv_temp`` = 1/temperature."""
    weight: torch.Tensor
    bias: torch.Tensor
    inv_temp: float


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def bn_relu_plain(feat: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """The conv operand: ``relu(F[:k] * scale + shift)`` in f32, rounded
    to the buffer's dtype (k = len(scale))."""
    k = scale.shape[0]
    a = feat[:, :k].to(torch.float32) * scale[:, None, None]
    return torch.relu(a + shift[:, None, None]).to(feat.dtype)


def dense_layer_plain(feat: torch.Tensor, layer: FoldedLayer) -> None:
    k, _, g = layer.weight.shape
    a = bn_relu_plain(feat, layer.scale, layer.shift)
    w = layer.weight.reshape(k, 3, 3, g).permute(3, 0, 1, 2)
    # padding=1 pads the post-ReLU activation: the conv's zero padding
    y = F.conv2d(a.to(torch.float32), w.to(torch.float32), padding=1)
    feat[:, k:k + g] = (y + layer.bias[:, None, None]).to(feat.dtype)


def transition_plain(feat: torch.Tensor, td: FoldedTransition) -> torch.Tensor:
    a = bn_relu_plain(feat, td.scale, td.shift)
    w = td.weight.t()[:, :, None, None]
    u = F.conv2d(a.to(torch.float32), w.to(torch.float32))
    return u.to(feat.dtype) + td.bias.to(feat.dtype)[:, None, None]


def classifier_plain(feat: torch.Tensor, cls: FoldedClassifier) -> torch.Tensor:
    f = feat.to(torch.float32)
    inv = 1.0 / torch.clamp(torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)),
                            min=1e-12)
    fn = (f * inv).to(feat.dtype).to(torch.float32)
    u = torch.einsum("oc,bchw->bohw", cls.weight.to(torch.float32), fn)
    return (u + cls.bias[:, None, None]) * cls.inv_temp


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built once)."""
    lib = build.load("dense_block")
    lib.s2r_conv_bnrelu.argtypes = [_I, _I, _P, _L, _I, _I, _I, _I, _P, _P,
                                    _P, _P, _I, _P, _L, _I, _P]
    lib.s2r_conv_bnrelu.restype = _I
    lib.s2r_classifier.argtypes = [_I, _P, _L, _I, _I, _L, _P, _P,
                                   ctypes.c_float, _P, _P]
    lib.s2r_classifier.restype = _I
    lib.s2r_error_string.argtypes = [_I]
    lib.s2r_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.s2r_error_string(err).decode()})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_feat(feat: torch.Tensor) -> None:
    _require(feat.is_cuda, "feature buffer must be a CUDA tensor")
    _require(feat.dtype in _DTYPE_CODE,
             f"feature dtype {feat.dtype} is not float32 or bfloat16")
    _require(feat.dim() == 4 and feat.is_contiguous(),
             "feature buffer must be a contiguous [B, C, H, W] tensor")


def _check_operand(t: torch.Tensor, feat: torch.Tensor, dtype, shape,
                   name: str) -> None:
    _require(t.device == feat.device and t.dtype == dtype
             and tuple(t.shape) == tuple(shape) and t.is_contiguous(),
             f"{name}: expected contiguous {dtype} {tuple(shape)} on "
             f"{feat.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _conv(feat, scale, shift, weight, bias, taps, out, round_first, what):
    b, c_total, h, w = feat.shape
    k, n = weight.shape[0], weight.shape[-1]
    _check_operand(scale, feat, torch.float32, (k,), f"{what} scale")
    _check_operand(shift, feat, torch.float32, (k,), f"{what} shift")
    _check_operand(weight, feat, feat.dtype, (k, taps, n) if taps > 1
                   else (k, n), f"{what} weight")
    _check_operand(bias, feat, torch.float32, (n,), f"{what} bias")
    _require(k <= c_total, f"{what}: reads {k} of {c_total} channels")
    lib = _lib()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.s2r_conv_bnrelu(
            _DTYPE_CODE[feat.dtype], taps, feat.data_ptr(), c_total * h * w,
            b, k, h, w, scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), n, out.data_ptr(), out.stride(0), round_first,
            stream)
    _check(lib, err, what)
    launches[what] += 1


def dense_layer(feat: torch.Tensor, layer: FoldedLayer) -> None:
    """Append one dense layer's ``g`` channels to ``feat`` in place: reads
    channels [0, c_j), writes [c_j, c_j + g)."""
    if not feat.is_cuda:
        return dense_layer_plain(feat, layer)
    _check_feat(feat)
    k, _, g = layer.weight.shape
    _require(k + g <= feat.shape[1],
             f"dense layer writes channels [{k}, {k + g}) of {feat.shape[1]}")
    out = feat[:, k:]  # the kernel writes channels [0, g) of this view
    _conv(feat, layer.scale, layer.shift, layer.weight, layer.bias, 9, out,
          0, "dense_layer")


def transition(feat: torch.Tensor, td: FoldedTransition) -> torch.Tensor:
    """TransitionDown before the pool: [B, C, H, W] -> [B, C_out, H, W]."""
    if not feat.is_cuda:
        return transition_plain(feat, td)
    _check_feat(feat)
    b, _, h, w = feat.shape
    out = torch.empty(b, td.weight.shape[1], h, w, dtype=feat.dtype,
                      device=feat.device)
    _conv(feat, td.scale, td.shift, td.weight, td.bias, 1, out, 1,
          "transition")
    return out


def classifier(feat: torch.Tensor, cls: FoldedClassifier) -> torch.Tensor:
    """Classifier tail: [B, C, H, W] -> f32 logits [B, 8, H, W]."""
    if not feat.is_cuda:
        return classifier_plain(feat, cls)
    _check_feat(feat)
    b, c, h, w = feat.shape
    _check_operand(cls.weight, feat, feat.dtype, (8, c), "classifier weight")
    _check_operand(cls.bias, feat, torch.float32, (8,), "classifier bias")
    out = torch.empty(b, 8, h, w, dtype=torch.float32, device=feat.device)
    lib = _lib()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.s2r_classifier(
            _DTYPE_CODE[feat.dtype], feat.data_ptr(), c * h * w, b, c, h * w,
            cls.weight.data_ptr(), cls.bias.data_ptr(), cls.inv_temp,
            out.data_ptr(), stream)
    _check(lib, err, "classifier")
    launches["classifier"] += 1
    return out


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _run_block(segments, layers, c_lo, td, cls, layer_fn: Callable,
               td_fn: Callable, cls_fn: Callable):
    b, _, h, w = segments[0].shape
    c_in = sum(s.shape[1] for s in segments)
    c_total = c_in + sum(lay.weight.shape[2] for lay in layers)
    feat = torch.empty(b, c_total, h, w, dtype=segments[0].dtype,
                       device=segments[0].device)
    off = 0
    for s in segments:  # the virtual concat
        feat[:, off:off + s.shape[1]].copy_(s)
        off += s.shape[1]
    for lay in layers:
        layer_fn(feat, lay)
    if cls is not None:
        return cls_fn(feat, cls)
    out = feat[:, c_lo:]
    if td is not None:
        return out, td_fn(feat, td)
    return out


def dense_block(segments: Sequence[torch.Tensor],
                layers: Sequence[FoldedLayer], *, c_lo: int,
                td: FoldedTransition | None = None,
                cls: FoldedClassifier | None = None):
    """One inference DenseBlock over the virtual concat of ``segments``
    ([B, C_i, H, W], all in the compute dtype).

    Returns ``F[:, c_lo:]`` (``c_lo=0``: the whole concat; ``c_lo=c_in``:
    the new features only), or ``(F[:, c_lo:], td_pre)`` with a
    TransitionDown ``td``, or f32 logits [B, 8, H, W] with a classifier
    tail ``cls``.
    """
    return _run_block(segments, layers, c_lo, td, cls,
                      dense_layer, transition, classifier)


def dense_block_plain(segments: Sequence[torch.Tensor],
                      layers: Sequence[FoldedLayer], *, c_lo: int,
                      td: FoldedTransition | None = None,
                      cls: FoldedClassifier | None = None):
    """``dense_block`` through the plain PyTorch versions only."""
    return _run_block(segments, layers, c_lo, td, cls,
                      dense_layer_plain, transition_plain, classifier_plain)

