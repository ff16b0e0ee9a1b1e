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

A bfloat16 ``dense_layer`` with growth 12 or 16 (``takes_mma_dense``:
every FCDenseNet57, FCDenseNet67 and FCDenseNet103 site), a bfloat16
``transition`` and the product of a bfloat16 ``classifier`` run on the
tensor cores; float32 and other growth rates (the test-only tiny net's 4)
on the CUDA cores.  The tensor-core dense layer reads its weight as
``[c_j, 9, 16]`` rows of 288 bytes: at growth 12 the folded weight is the
``[c_j, 9, 12]`` view of such a buffer whose columns 12-15 are zero
(``pad_growth``, made once at fold time), and the wrapper refuses any
other layout there (``mma_layout``).  The classifier stages all channels
of ``CLS_PIXELS`` pixels in shared memory (``classifier_smem`` bytes a
block) and reads each feature once.  At small planes the tensor-core dense
layer splits its channel loop across a cluster of ``dense_splits`` blocks.
The C library chooses the route and the split and reports both with each
launch; ``takes_mma_dense`` and ``dense_splits`` state its rules for the
CPU tests.  Each wrapper takes a CPU tensor to its plain version and a CUDA
tensor to its kernel; a failed build or launch raises.  ``launches``
counts kernel launches per entry point (CUDA tensors only),
``mma_launches`` the dense-layer launches that the C library reports on
the tensor cores, and ``mma_splits`` those by the blocks that split their
channel loop.

``dense_layer(..., ablate=)`` runs a diagnostic variant of the tensor-core
dense layer (``cli/serve_breakdown --ablate``): ``"no_taps"`` multiplies
the centre tap alone, ``"no_prep"`` convolves x without BN + ReLU, wrong
math at the same launch, so that a level's time can be split between the
two.  Only the tensor-core route has them: any other layer raises
``ValueError``.  ``ablate_launches`` counts their launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import build

launches = {"dense_layer": 0, "transition": 0, "classifier": 0}
mma_launches = {"dense_layer": 0}
# the diagnostic variants of the tensor-core dense layer, by their C mode
ABLATIONS = {"no_taps": 1, "no_prep": 2}
ablate_launches = {k: 0 for k in ABLATIONS}
mma_splits: dict[int, int] = {}

# the tensor-core dense layer (csrc/dense3x3_mma.cuh): the growths it is
# built for, the width its weight rows are padded to, pixel tile, channels
# per chunk, most blocks in a split and the blocks per SM it aims at
MMA_GROWTHS = (12, 16)
MMA_WIDTH = 16
MMA_TILE = (12, 16)
MMA_CHUNK = 32
MAX_SPLITS = 8
BLOCKS_PER_SM = 2

# the classifier (csrc/dense_block.cu classifier_kernel): pixels a warp,
# warps a block, and the most shared memory a block may hold on sm_90
CLS_WARP_PIXELS = 16
CLS_WARPS = 4
CLS_PIXELS = CLS_WARP_PIXELS * CLS_WARPS
CLS_SMEM_MAX = 232_448


def reset_launches() -> None:
    for counts in (launches, mma_launches, ablate_launches):
        for k in counts:
            counts[k] = 0
    mma_splits.clear()


def takes_mma_dense(dtype: torch.dtype, g: int) -> bool:
    """Whether ``dense_layer`` takes the tensor-core kernel: the C
    library's rule, stated for the CPU tests."""
    return dtype == torch.bfloat16 and g in MMA_GROWTHS


def pad_growth(rows: torch.Tensor, dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """``[c, taps, g]`` weight rows (any strides) in ``dtype`` (default:
    theirs) as the ``[c, taps, g]`` view of a zeroed ``[c, taps,
    MMA_WIDTH]`` buffer: the layout the tensor-core 3x3 kernels read (one
    288-byte row a channel, 16-byte aligned for cp.async; columns g-15
    zero).  One fill and one copy, which replace the copy that lays the
    rows out.  At g = MMA_WIDTH the rows come back contiguous."""
    c, taps, g = rows.shape
    dtype = rows.dtype if dtype is None else dtype
    if g == MMA_WIDTH:
        return rows.to(dtype).contiguous()
    buf = torch.zeros(c, taps, MMA_WIDTH, dtype=dtype, device=rows.device)
    buf[:, :, :g] = rows
    return buf[:, :, :g]


def mma_layout(weight: torch.Tensor) -> bool:
    """Whether ``weight`` [c, taps, g] lies as ``pad_growth`` lays it out:
    rows ``taps * MMA_WIDTH`` elements apart, a tap ``MMA_WIDTH``."""
    return (weight.dim() == 3 and weight.shape[2] <= MMA_WIDTH
            and weight.stride() == (weight.shape[1] * MMA_WIDTH, MMA_WIDTH, 1))


def dense_splits(b: int, h: int, w: int, c: int, sms: int) -> int:
    """The blocks (one cluster) that split the tensor-core dense layer's
    channel loop for a [b, c, h, w] input on a card of ``sms`` SMs: the
    least number that gives BLOCKS_PER_SM blocks per SM, at most MAX_SPLITS
    and at most one per 32-channel chunk (the C library's rule, stated for
    the CPU tests)."""
    th, tw = MMA_TILE
    blocks = b * -(-h // th) * -(-w // tw)
    chunks = -(-c // MMA_CHUNK)
    return max(1, min(-(-BLOCKS_PER_SM * sms // blocks), MAX_SPLITS, chunks))


def classifier_smem(c: int, dtype: torch.dtype) -> int:
    """Shared memory of one classifier block over ``c`` channels: the
    [cp][CLS_PIXELS] feature tile (cp = c rounded up to 16; a warp takes
    CLS_WARP_PIXELS of the pixels), and in float32 the weights as [cp][8]
    (bfloat16 reads them from device memory); the C library's rule, stated
    for the CPU tests."""
    item = torch.empty((), dtype=dtype).element_size()
    cp = -(-c // 16) * 16
    weights = 0 if item == 2 else cp * 8 * 4
    return cp * CLS_PIXELS * item + weights


class FoldedLayer(NamedTuple):
    """One DenseLayer with its BatchNorm folded: ``scale``/``shift`` [c_j]
    f32, ``weight`` [c_j, 9, g] in the compute dtype (tap = ky*3+kx;
    contiguous, or where ``takes_mma_dense`` the ``pad_growth`` layout),
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


def dense_layer_plain(feat: torch.Tensor, layer: FoldedLayer,
                      ablate: str | None = None) -> None:
    k, _, g = layer.weight.shape
    if ablate == "no_prep":
        a = feat[:, :k]
    else:
        a = bn_relu_plain(feat, layer.scale, layer.shift)
    w = layer.weight.reshape(k, 3, 3, g).permute(3, 0, 1, 2)
    if ablate == "no_taps":
        w = w[:, :, 1:2, 1:2]
    # the padding pads the post-ReLU activation: the conv's zero padding
    y = F.conv2d(a.to(torch.float32), w.to(torch.float32),
                 padding=w.shape[-1] // 2)
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
                                    _P, _P, _I, _P, _L, _I, _I,
                                    ctypes.POINTER(_I), _P]
    lib.s2r_conv_bnrelu.restype = _I
    lib.s2r_classifier.argtypes = [_I, _P, _L, _I, _I, _L, _P, _P,
                                   ctypes.c_float, _P, _P]
    lib.s2r_classifier.restype = _I
    lib.s2r_classifier_smem.argtypes = [_I, _I]
    lib.s2r_classifier_smem.restype = _L
    lib.s2r_dense_splits.argtypes = [_I, _I, _I, _I]
    lib.s2r_dense_splits.restype = _I
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
                   what: str, name: str, padded: bool = False) -> None:
    """``padded``: the ``pad_growth`` layout instead of contiguous."""
    layout = mma_layout(t) if padded else t.is_contiguous()
    if not (t.device == feat.device and t.dtype == dtype
            and t.shape == shape and layout):
        want = (f"rows padded to {MMA_WIDTH} columns (pad_growth)" if padded
                else "contiguous")
        raise ValueError(
            f"{what} {name}: expected {want} {dtype} {tuple(shape)} on "
            f"{feat.device}, got {t.dtype} {tuple(t.shape)} strides "
            f"{t.stride()} on {t.device}")


def _conv(feat, scale, shift, weight, bias, taps, out, round_first,
          what, ablate=None) -> int:
    """One launch; returns the route the C library took (``s2r_conv_bnrelu``:
    0 on the CUDA cores).  ``ablate``: the tensor-core dense layer's
    diagnostic variant to launch (``ABLATIONS``), counted apart."""
    b, c_total, h, w = feat.shape
    k, n = weight.shape[0], weight.shape[-1]
    _check_operand(scale, feat, torch.float32, (k,), what, "scale")
    _check_operand(shift, feat, torch.float32, (k,), what, "shift")
    _check_operand(weight, feat, feat.dtype, (k, taps, n) if taps > 1
                   else (k, n), what, "weight",
                   taps > 1 and takes_mma_dense(feat.dtype, n))
    _check_operand(bias, feat, torch.float32, (n,), what, "bias")
    _require(k <= c_total, f"{what}: reads {k} of {c_total} channels")
    lib = _lib()
    route = _I(0)
    with build.on_device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.s2r_conv_bnrelu(
            _DTYPE_CODE[feat.dtype], taps, feat.data_ptr(), c_total * h * w,
            b, k, h, w, scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), n, out.data_ptr(), out.stride(0), round_first,
            ABLATIONS[ablate] if ablate else 0, ctypes.byref(route), stream)
    _check(lib, err, what)
    if ablate:
        ablate_launches[ablate] += 1
    else:
        launches[what] += 1
    return route.value


def dense_layer(feat: torch.Tensor, layer: FoldedLayer,
                ablate: str | None = None) -> None:
    """Append one dense layer's ``g`` channels to ``feat`` in place: reads
    channels [0, c_j), writes [c_j, c_j + g).  ``ablate``: a diagnostic
    variant (``ABLATIONS``) of the tensor-core layer.  The kernel on the
    tensor-core route takes the weight in the ``pad_growth`` layout; the
    plain version takes either layout and reads the [c_j, 9, g] view."""
    k, _, g = layer.weight.shape
    if ablate is not None:
        _require(ablate in ABLATIONS,
                 f"ablate {ablate!r} is not one of {sorted(ABLATIONS)}")
        _require(takes_mma_dense(feat.dtype, g),
                 f"ablate is a tensor-core-route diagnostic (bfloat16, "
                 f"growth {' or '.join(map(str, MMA_GROWTHS))}); this layer "
                 f"is {feat.dtype} with "
                 f"growth {g}, which runs on the CUDA cores")
    if not feat.is_cuda:
        return dense_layer_plain(feat, layer, ablate)
    _check_feat(feat)
    _require(k + g <= feat.shape[1],
             f"dense layer writes channels [{k}, {k + g}) of {feat.shape[1]}")
    out = feat[:, k:]  # the kernel writes channels [0, g) of this view
    splits = _conv(feat, layer.scale, layer.shift, layer.weight, layer.bias,
                   9, out, 0, "dense_layer", ablate)
    if splits > 0 and ablate is None:
        # the tensor-core kernel, its channel loop in `splits`
        mma_launches["dense_layer"] += 1
        mma_splits[splits] = mma_splits.get(splits, 0) + 1


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
    _check_operand(cls.weight, feat, feat.dtype, (8, c), "classifier", "weight")
    _check_operand(cls.bias, feat, torch.float32, (8,), "classifier", "bias")
    _require(classifier_smem(c, feat.dtype) <= CLS_SMEM_MAX,
             f"classifier: {c} {feat.dtype} channels exceed one block's "
             f"shared memory")
    out = torch.empty(b, 8, h, w, dtype=torch.float32, device=feat.device)
    lib = _lib()
    with build.on_device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
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

