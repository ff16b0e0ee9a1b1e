"""K6: the LaneNetLite int8 residual body plus the 1x1 head, on the
hand-written CUDA kernels of ``csrc/int8_body.cu``, with the plain
PyTorch version.

Counterpart of ``_body_kernel`` in the JAX package's
``models/lanenet_pallas.py`` (launched by ``_run_body``).  The body works
on rows of pixels: the f32 stem output ``[B, h*w, C]`` in, f32 logits
``[B, h*w, n_classes]`` out.  Per ResBlock, with every activation code an
int8 ``q`` that stands for ``act_scale * (q + zp)``:

- ``q_in = quant(h, conv1)``: ``clip(rint(h / act_scale) - zp)``;
- conv1, a 3x3 (dilated) conv as an exact int8 x int8 -> int32 sum over
  the nine tap views, the border filled with the code ``-zp``; its
  epilogue ``(float(acc) + zp*colsum) * (act_scale*w_scale) + bias``,
  ReLU, then requant with conv2's scale;
- the shortcut: ``h`` itself, or a 1x1 int8 conv of ``q_in`` (same
  epilogue, no ReLU);
- conv2 (no ReLU), then ``h = max(a2 + short, 0)`` in f32, the residual
  carry, and its requant with the next block's conv1 scale;
- after the last block, the f32 head ``h @ W + b``.

``int8_body`` runs each conv as one launch with its epilogue fused (and
the quantize and head launches): on the int8 tensor cores (IMMA) where
``takes_imma`` holds (every site of the full-width student), else on the
CUDA cores (``__dp4a``); ``int8_body_plain`` computes the same with
PyTorch ops, the int sums exactly in float64 (every partial sum of int8
products stays far below 2^53).  Every step but the head is bit-exact
between the two; the head sums 128 f32 products in another order.
``int8_body`` takes a CPU tensor to its plain version and a CUDA tensor to
the kernels; a failed build or launch raises.  The C library chooses each
conv's route and reports it with the launch; ``takes_imma`` and
``imma_tiles`` state its rule for the CPU tests.  ``launches`` counts
kernel launches per entry (CUDA tensors only), ``mma_launches`` the conv
launches that the C library reports on the tensor cores, and
``imma_buffers`` those by the halo tiles (1 or 2) they kept in shared
memory.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import build

launches = {"quant": 0, "conv": 0, "head": 0}
mma_launches = {"conv": 0}
imma_buffers = {1: 0, 2: 0}

# the int8 tensor-core conv (csrc/int8_body.cu): output pixel tile,
# outputs per block, a block's shared memory on sm_90 (227 KB opt-in)
IMMA_TILE = (16, 8)
IMMA_NB = 128
SMEM_MAX = 232448


def reset_launches() -> None:
    for counts in (launches, mma_launches, imma_buffers):
        for k in counts:
            counts[k] = 0


def imma_tiles(cin: int, cout: int, taps: int, dilation: int) -> int:
    """Halo tiles the int8 tensor-core kernel keeps in shared memory beside
    every tap's weights (and three f32 constants per output): 2 (the next
    tile in flight during the products), 1, or 0 where not even one fits
    (the C library's ``im_tiles``, stated for the CPU tests)."""
    lda = cin + 16
    rows = 32 * -(-min(cout, IMMA_NB) // 32)
    h = dilation if taps == 9 else 0
    weights = taps * rows * lda + 3 * 4 * IMMA_NB
    tile = (IMMA_TILE[0] + 2 * h) * (IMMA_TILE[1] + 2 * h) * lda
    return (2 if weights + 2 * tile <= SMEM_MAX
            else 1 if weights + tile <= SMEM_MAX else 0)


def takes_imma(cin: int, cout: int, taps: int, dilation: int) -> bool:
    """Whether a conv site takes the int8 tensor-core kernel (the C
    library's rule, stated for the CPU tests): whole 32-byte k steps, whole
    8-output tiles, and its weights and a halo tile fit in shared memory."""
    return (cin % 32 == 0 and cout % 8 == 0
            and imma_tiles(cin, cout, taps, dilation) > 0)


class ConvSpec(NamedTuple):
    """One quantized conv site, packed for the kernel.

    ``w_rows`` int8 [taps*cin, cout] (row ``tap*cin + ci``, tap =
    ky*3+kx); ``w_words`` int32 [taps*cin/4, cout], four consecutive rows
    per word (little-endian), for the CUDA-core kernel; ``w_cols`` int8
    [taps*cout, cin] (row ``tap*cout + o``), for the tensor cores;
    ``zpsum`` = zp * colsum, ``deq`` = act_scale * w_scale and ``bias``,
    f32 [cout]; ``act_scale`` the f32 scale of the
    conv's input codes as a 0-d tensor on the device and ``act`` as a
    Python float (the same value)."""
    name: str
    w_rows: torch.Tensor
    w_words: torch.Tensor
    w_cols: torch.Tensor
    zpsum: torch.Tensor
    deq: torch.Tensor
    bias: torch.Tensor
    act_scale: torch.Tensor
    act: float
    zp: int
    taps: int
    dilation: int
    relu: bool


class Int8Body(NamedTuple):
    """The ResBlocks as (conv1, conv2, shortcut or None), and the head:
    ``head_w`` f32 [C, n_classes], ``head_b`` f32 [n_classes]."""
    blocks: Sequence[tuple[ConvSpec, ConvSpec, ConvSpec | None]]
    head_w: torch.Tensor
    head_b: torch.Tensor


def conv_spec(name: str, site: dict) -> ConvSpec:
    """Pack a quantized site (``models.lanenet_int8``: HWIO int8 ``w_q``)
    for the body."""
    kh, kw, cin, cout = site["w_q"].shape
    if cin % 4:
        raise ValueError(f"{name}: {cin} input channels, not a multiple of 4")
    w_rows = site["w_q"].reshape(kh * kw * cin, cout).contiguous()
    words = w_rows.reshape(-1, 4, cout).transpose(1, 2).contiguous()
    return ConvSpec(
        name=name, w_rows=w_rows,
        w_words=words.view(torch.int32).reshape(-1, cout),
        w_cols=site["w_q"].permute(0, 1, 3, 2).reshape(kh * kw * cout, cin)
        .contiguous(),
        zpsum=site["zp"] * site["w_colsum"],
        deq=site["act_scale"] * site["w_scale"], bias=site["bias"],
        act_scale=site["act_scale"], act=float(site["act_scale"]),
        zp=int(site["zp"]), taps=kh * kw, dilation=int(site["dilation"]),
        relu=bool(site["relu"]))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def quantize_plain(x: torch.Tensor, act_scale: torch.Tensor,
                   zp: int) -> torch.Tensor:
    """float -> int8 code: ``clip(round(x / act_scale) - zp)``.  Rounds
    half to even; divides by a tensor on ``x``'s device (PyTorch's CUDA
    division by a CPU scalar multiplies by its reciprocal instead)."""
    q = torch.round(torch.div(x, act_scale.to(x.device))) - zp
    return torch.clamp(q, -128, 127).to(torch.int8)


def conv_acc_plain(q: torch.Tensor, w_rows: torch.Tensor, k: int,
                   stride: int, dilation: int, pads, zp: int) -> torch.Tensor:
    """Exact int8 conv sums: codes ``q`` [B, H, W, Cin] padded by ``pads``
    ((top, bottom), (left, right)) with the code ``-zp``, against
    ``w_rows`` [k*k*Cin, Cout]; float32 [B, Ho, Wo, Cout].  The sums run
    in float64, where every partial sum of int8 products is exact."""
    (pt, pb), (pl, pr) = pads
    x = F.pad(q.to(torch.float64), (0, 0, pl, pr, pt, pb), value=-zp)
    ho = (x.shape[1] - dilation * (k - 1) - 1) // stride + 1
    wo = (x.shape[2] - dilation * (k - 1) - 1) // stride + 1
    taps = [x[:, ky * dilation:ky * dilation + stride * (ho - 1) + 1:stride,
              kx * dilation:kx * dilation + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    a = torch.stack(taps, dim=3).reshape(-1, k * k * q.shape[3])
    acc = a @ w_rows.to(torch.float64)
    return acc.to(torch.float32).reshape(q.shape[0], ho, wo, -1)


def epilogue_plain(acc: torch.Tensor, zpsum: torch.Tensor, deq: torch.Tensor,
                   bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """``(acc + zp*colsum) * (act_scale*w_scale) + bias`` [, ReLU]."""
    y = (acc + zpsum) * deq + bias
    return torch.clamp(y, min=0.0) if relu else y


def _conv_plain(q: torch.Tensor, spec: ConvSpec, h: int, w: int):
    b = q.shape[0]
    k = 3 if spec.taps == 9 else 1
    p = spec.dilation * (k // 2)
    acc = conv_acc_plain(q.reshape(b, h, w, -1), spec.w_rows, k, 1,
                         spec.dilation, ((p, p), (p, p)), spec.zp)
    return epilogue_plain(acc.reshape(b, h * w, -1), spec.zpsum, spec.deq,
                          spec.bias, spec.relu)


def int8_body_plain(x: torch.Tensor, body: Int8Body, h: int, w: int,
                    record: dict | None = None) -> torch.Tensor:
    """``int8_body`` through PyTorch ops only."""
    blocks = body.blocks
    hf = x
    q_in = quantize_plain(x, blocks[0][0].act_scale, blocks[0][0].zp)
    for i, (c1, c2, short) in enumerate(blocks):
        a1 = quantize_plain(_conv_plain(q_in, c1, h, w), c2.act_scale, c2.zp)
        if record is not None:
            record[c1.name], record[c2.name] = q_in, a1
        res = hf if short is None else _conv_plain(q_in, short, h, w)
        hf = torch.clamp(_conv_plain(a1, c2, h, w) + res, min=0.0)
        if i + 1 < len(blocks):
            nxt = blocks[i + 1][0]
            q_in = quantize_plain(hf, nxt.act_scale, nxt.zp)
    return hf @ body.head_w + body.head_b


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built once)."""
    lib = build.load("int8_body")
    lib.s2r_i8_quant.argtypes = [_P, _L, _F, _F, _P, _P]
    lib.s2r_i8_conv.argtypes = [_I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                                _P, _P, _P, _I, _P, _P, _P, _F, _F,
                                ctypes.POINTER(_I), _P]
    lib.s2r_i8_head.argtypes = [_P, _L, _I, _P, _P, _I, _P, _P]
    lib.s2r_i8_imma_tiles.argtypes = [_I, _I, _I, _I]
    lib.s2r_i8_imma_tiles.restype = _I
    for fn in (lib.s2r_i8_quant, lib.s2r_i8_conv, lib.s2r_i8_head):
        fn.restype = _I
    lib.s2r_i8_error_string.argtypes = [_I]
    lib.s2r_i8_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"int8 body {what} launch failed: CUDA error {err} "
                           f"({lib.s2r_i8_error_string(err).decode()})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_spec(spec: ConvSpec, dev: torch.device) -> None:
    rows, cout = spec.w_rows.shape
    for name, t, dtype, shape in (
            ("w_words", spec.w_words, torch.int32, (rows // 4, cout)),
            ("w_cols", spec.w_cols, torch.int8,
             (spec.taps * cout, rows // spec.taps)),
            ("zpsum", spec.zpsum, torch.float32, (cout,)),
            ("deq", spec.deq, torch.float32, (cout,)),
            ("bias", spec.bias, torch.float32, (cout,))):
        _require(t.device == dev and t.dtype == dtype
                 and tuple(t.shape) == shape and t.is_contiguous(),
                 f"{spec.name} {name}: expected contiguous {dtype} {shape} on "
                 f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    _require(spec.taps in (1, 9), f"{spec.name}: {spec.taps} taps")
    _require(spec.zp in (0, 128), f"{spec.name}: zero point {spec.zp}")


def _quant(x: torch.Tensor, nxt: ConvSpec) -> torch.Tensor:
    lib = _lib()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _check(lib, lib.s2r_i8_quant(x.data_ptr(), x.numel(), nxt.act,
                                 float(nxt.zp), q.data_ptr(), _stream(x)),
           "quant")
    launches["quant"] += 1
    return q


def _conv(q: torch.Tensor, spec: ConvSpec, h: int, w: int, *,
          res: torch.Tensor | None = None, out_f: bool = False,
          nxt: ConvSpec | None = None):
    """One conv launch: returns (f32 output or None, next codes or None)."""
    b, _, cin = q.shape
    cout = spec.w_rows.shape[1]
    _require(spec.w_rows.shape[0] == spec.taps * cin,
             f"{spec.name}: weight rows {spec.w_rows.shape[0]} for {cin} "
             f"input channels")
    y = torch.empty(b, h * w, cout, dtype=torch.float32,
                    device=q.device) if out_f else None
    qo = torch.empty(b, h * w, cout, dtype=torch.int8,
                     device=q.device) if nxt is not None else None
    lib = _lib()
    route = _I(0)  # the halo tiles of the tensor-core kernel, 0: CUDA cores
    err = lib.s2r_i8_conv(
        spec.taps, q.data_ptr(), b, h, w, cin, spec.dilation, spec.zp,
        spec.w_words.data_ptr(), spec.w_cols.data_ptr(), cout,
        spec.zpsum.data_ptr(),
        spec.deq.data_ptr(), spec.bias.data_ptr(), int(spec.relu), _ptr(res),
        _ptr(y), _ptr(qo), nxt.act if nxt is not None else 1.0,
        float(nxt.zp) if nxt is not None else 0.0, ctypes.byref(route),
        _stream(q))
    _check(lib, err, spec.name)
    launches["conv"] += 1
    if route.value > 0:
        mma_launches["conv"] += 1
        imma_buffers[route.value] += 1
    return y, qo


def _head(hf: torch.Tensor, body: Int8Body) -> torch.Tensor:
    b, p, c = hf.shape
    n = body.head_w.shape[1]
    _require(n <= 8 and tuple(body.head_w.shape) == (c, n)
             and body.head_w.dtype == torch.float32
             and body.head_b.dtype == torch.float32
             and body.head_w.device == hf.device
             and body.head_b.device == hf.device
             and body.head_w.is_contiguous() and body.head_b.is_contiguous(),
             f"head: expected f32 [{c}, <=8] weights on {hf.device}")
    out = torch.empty(b, p, n, dtype=torch.float32, device=hf.device)
    lib = _lib()
    _check(lib, lib.s2r_i8_head(hf.data_ptr(), b * p, c,
                                body.head_w.data_ptr(), body.head_b.data_ptr(),
                                n, out.data_ptr(), _stream(hf)), "head")
    launches["head"] += 1
    return out


def int8_body(x: torch.Tensor, body: Int8Body, h: int, w: int,
              record: dict | None = None) -> torch.Tensor:
    """The body plus head: f32 stem output ``x`` [B, h*w, C] -> f32 logits
    [B, h*w, n_classes].  ``record``, if given, receives each conv site's
    input codes (int8 [B, h*w, cin]) by site name."""
    if not x.is_cuda:
        return int8_body_plain(x, body, h, w, record)
    _require(x.dtype == torch.float32 and x.dim() == 3
             and x.shape[1] == h * w and x.is_contiguous(),
             f"stem output must be contiguous f32 [B, {h * w}, C], got "
             f"{x.dtype} {tuple(x.shape)}")
    blocks = body.blocks
    for specs in blocks:
        for s in specs:
            if s is not None:
                _check_spec(s, x.device)
    with torch.cuda.device(x.device):
        hf = x
        q_in = _quant(x, blocks[0][0])
        for i, (c1, c2, short) in enumerate(blocks):
            _, a1 = _conv(q_in, c1, h, w, nxt=c2)
            if record is not None:
                record[c1.name], record[c2.name] = q_in, a1
            res = hf if short is None else _conv(q_in, short, h, w,
                                                 out_f=True)[0]
            nxt = blocks[i + 1][0] if i + 1 < len(blocks) else None
            hf, q_in = _conv(a1, c2, h, w, res=res, out_f=True, nxt=nxt)
        return _head(hf, body)
