"""Int8 post-training quantization for LaneNetLite serving.

Counterpart of ``sim2real_lane_segment_tpu.models.lanenet_int8``:

- BatchNorm folds into the conv ahead of it (per-output-channel scale and
  bias), since serving uses running statistics;
- weights are symmetric per-output-channel int8; activations per-tensor
  int8 with scales from the 99.95th percentile of |x| on a calibration
  batch.  The first stem conv's (signed) input has zero point 0 and
  range 127; every other, post-ReLU, input has zero point 128 over 255
  codes, and a shortcut conv reads its block's conv1 codes;
- a conv is an exact int8 x int8 sum, then ``(float(acc) + zp*colsum) *
  (act_scale*w_scale) + bias`` [, ReLU]; borders are filled with the code
  of x = 0 (``-zp``), so they dequantize exactly;
- residual adds and the 1x1 head stay float32.

The int sums reach 9*128*128*127 (~1.9e7, above 2^24), so a float32 conv
would not be exact: ``_conv_i8`` sums in float64 (``kernels.int8_body.
conv_acc_plain``), exact on the CPU and on the card.  Rounding is half to
even (``jnp.round`` is ``torch.round``).  Activations are NHWC, as in the
JAX functions; ``quantize_lanenet`` reads the folded weights from a
``models.lanenet_lite.LaneNetLite`` and its calibration forward runs with
TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.int8_body import conv_acc_plain, epilogue_plain, quantize_plain
from ..ops.resize import resize_bilinear
from .lanenet_lite import EPS, LaneNetLite, conv_same, same_pad


def _fold_bn(weight: torch.Tensor, bn) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference-mode BatchNorm into the OIHW conv ahead of it."""
    scale = bn.weight * torch.rsqrt(bn.running_var + EPS)
    shift = bn.bias - bn.running_mean * scale
    return weight * scale[:, None, None, None], shift


def _graph(model: LaneNetLite):
    """The ordered conv sites of LaneNetLite + the block structure."""
    stem = [(f"ConvBN_{i}", 2) for i in range(len(model.stem))]
    blocks = [(f"ResBlock_{i}", d) for i, (_, d) in enumerate(model.body)]
    return stem, blocks


class QuantizedLaneNet:
    """The quantized network: per-site int8 HWIO kernels, scales and
    biases (tensors on the model's device), and the f32 head (``head_
    kernel`` HWIO [1, 1, C, n], ``head_bias`` [n]).  ``body`` caches the
    sites packed for kernel K6 (``models.lanenet_fused``)."""

    def __init__(self, model: LaneNetLite, sites: dict, head_kernel,
                 head_bias):
        self.model = model
        self.sites = sites
        self.head_kernel = head_kernel
        self.head_bias = head_bias
        self.body = None


@torch.no_grad()
def _collect_float_layers(model: LaneNetLite) -> dict:
    """(ordered site name -> dict with folded float OIHW kernel + metadata)."""
    fe = model.featureExtractor
    stem, blocks = _graph(model)
    layers: dict[str, dict] = {}
    for name, stride in stem:
        m = getattr(fe, name)
        w, b = _fold_bn(m.Conv_0.weight, m.BatchNorm_0)
        layers[name] = dict(kernel=w, bias=b, stride=stride, dilation=1,
                            relu=True)
    for name, dil in blocks:
        m = getattr(fe, name)
        w1, b1 = _fold_bn(m.ConvBN_0.Conv_0.weight, m.ConvBN_0.BatchNorm_0)
        layers[f"{name}/conv1"] = dict(kernel=w1, bias=b1, stride=1,
                                       dilation=dil, relu=True)
        w2, b2 = _fold_bn(m.Conv_0.weight, m.BatchNorm_0)
        layers[f"{name}/conv2"] = dict(kernel=w2, bias=b2, stride=1,
                                       dilation=dil, relu=False)
        if hasattr(m, "Conv_1"):
            layers[f"{name}/short"] = dict(
                kernel=m.Conv_1.weight, bias=torch.zeros_like(b2), stride=1,
                dilation=1, relu=False)
    return layers


def _conv_f32(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """NCHW float32 conv of the folded graph."""
    y = conv_same(x, layer["kernel"].to(torch.float32), layer["stride"],
                  layer["dilation"]) + layer["bias"][:, None, None]
    return torch.clamp(y, min=0.0) if layer["relu"] else y


def percentile_f32(t: torch.Tensor, pct: float) -> float:
    """``jnp.percentile(t, pct)``: float32, linear interpolation between
    the sorted neighbours at ``pct/100 * (n - 1)``, every step in float32
    (``torch.quantile`` refuses inputs over 2^24 elements).  It follows
    what XLA compiles: the position is ``pct * (0.01 * (n - 1))`` (the
    division by 100 becomes a product with 0.01, and the two constant
    factors fold), and ``lo*lw + hi*hw`` is one fused multiply-add; each
    moves the result by a float32 step on some inputs."""
    a = torch.sort(t.reshape(-1).to(torch.float32)).values
    f32 = torch.float32
    n = torch.tensor(float(a.numel()), dtype=f32)
    q = torch.tensor(pct, dtype=f32) * (torch.tensor(0.01, dtype=f32)
                                        * (n - 1))
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    lo = a[int(torch.clamp(low, 0, n - 1))].cpu()
    hi = a[int(torch.clamp(high, 0, n - 1))].cpu()
    f64 = torch.float64  # the product of two float32 is exact in float64
    return float(((lo * lw).to(f64) + hi.to(f64) * hw.to(f64)).to(f32))


def _float_forward(model: LaneNetLite, layers: dict, x: torch.Tensor,
                   record: dict | None = None) -> torch.Tensor:
    """Float shadow forward over the folded graph, NHWC in and out;
    ``record`` collects the 99.95th percentile of |x| of every quantized
    conv's INPUT."""

    def note(name, t):
        if record is not None:
            record[name] = max(record.get(name, 0.0),
                               percentile_f32(t.abs(), 99.95))
        return t

    stem, blocks = _graph(model)
    h = x.permute(0, 3, 1, 2)
    for name, _ in stem:
        h = _conv_f32(note(name, h), layers[name])
    for name, _ in blocks:
        inp = note(f"{name}/conv1", h)
        a = _conv_f32(inp, layers[f"{name}/conv1"])
        a = _conv_f32(note(f"{name}/conv2", a), layers[f"{name}/conv2"])
        short = _conv_f32(inp, layers[f"{name}/short"]) \
            if f"{name}/short" in layers else h
        h = torch.clamp(a + short, min=0.0)
    return h.permute(0, 2, 3, 1)


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@torch.no_grad()
def quantize_lanenet(model: LaneNetLite, calib_x: torch.Tensor
                     ) -> QuantizedLaneNet:
    """Fold BN, calibrate activation scales on ``calib_x`` (normalized
    float NHWC), and quantize every conv to per-channel int8.  The sites
    live on the model's device."""
    dev = next(model.parameters()).device
    layers = _collect_float_layers(model)
    record: dict[str, float] = {}
    with _no_tf32():
        _float_forward(model, layers, calib_x.to(dev, torch.float32),
                       record=record)
    record = {k: max(v, 1e-6) for k, v in record.items()}

    stem_first = _graph(model)[0][0][0]
    sites = {}
    for name, layer in layers.items():
        # HWIO, as the JAX kernels
        w = layer["kernel"].permute(2, 3, 1, 0).cpu().numpy().astype(
            np.float32)
        w_scale = np.maximum(np.abs(w).max(axis=(0, 1, 2)),
                             np.float32(1e-8)) / np.float32(127.0)
        w_q = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
        a_key = name if name in record else name.rsplit("/", 1)[0] + "/conv1"
        zp = 0 if a_key == stem_first else 128
        act_scale = record[a_key] / (127.0 if zp == 0 else 255.0)
        sites[name] = dict(
            w_q=torch.from_numpy(w_q).to(dev),
            w_scale=torch.from_numpy(w_scale).to(dev),
            w_colsum=torch.from_numpy(
                w_q.astype(np.int64).sum(axis=(0, 1, 2)).astype(
                    np.float32)).to(dev),
            bias=layer["bias"].detach().to(dev, torch.float32).contiguous(),
            act_scale=torch.tensor(np.float32(act_scale), device=dev),
            zp=zp, stride=layer["stride"], dilation=layer["dilation"],
            relu=layer["relu"])

    head = model.classifier.head
    return QuantizedLaneNet(
        model, sites,
        head.weight.detach().permute(2, 3, 1, 0).to(torch.float32)
        .contiguous(), head.bias.detach().to(torch.float32))


def _conv_i8(x_q: torch.Tensor, site: dict) -> torch.Tensor:
    """int8 NHWC conv, exact sums; returns float32 (dequant + bias [+
    ReLU]).  The code q stands for scale * (q + zp); padding uses the code
    of x = 0 (-zp), and the zp cross term is the per-output-channel
    constant zp * sum(W)."""
    kh, kw, cin, cout = site["w_q"].shape
    d, st = site["dilation"], site["stride"]
    pads = (same_pad(x_q.shape[1], kh, st, d), same_pad(x_q.shape[2], kw, st,
                                                       d))
    acc = conv_acc_plain(x_q, site["w_q"].reshape(kh * kw * cin, cout), kh,
                         st, d, pads, site["zp"])
    return epilogue_plain(acc, site["zp"] * site["w_colsum"],
                          site["act_scale"] * site["w_scale"], site["bias"],
                          site["relu"])


def _quant(x_f: torch.Tensor, site: dict) -> torch.Tensor:
    """float -> int8 code: q = round(x / scale) - zp."""
    return quantize_plain(x_f, site["act_scale"], site["zp"])


def stem_forward(qn: QuantizedLaneNet, x: torch.Tensor) -> torch.Tensor:
    """The two stride-2 stem convs, exact: normalized float NHWC input ->
    f32 NHWC features at /4."""
    stem, _ = _graph(qn.model)
    h_f = None
    h_q = _quant(x.to(torch.float32), qn.sites[stem[0][0]])
    for name, _ in stem:
        site = qn.sites[name]
        if h_f is not None:
            h_q = _quant(h_f, site)
        h_f = _conv_i8(h_q, site)
    return h_f


@torch.no_grad()
def int8_apply(qn: QuantizedLaneNet, x: torch.Tensor, *,
               use_softmax: bool = False) -> torch.Tensor:
    """Quantized forward: normalized float NHWC input -> NHWC class scores
    at the input's /4 size x 4, matching ``model(..., train=False)``."""
    _, blocks = _graph(qn.model)
    h_f = stem_forward(qn, x)
    for name, _ in blocks:
        s1 = qn.sites[f"{name}/conv1"]
        in_q = _quant(h_f, s1)
        a = _conv_i8(in_q, s1)
        s2 = qn.sites[f"{name}/conv2"]
        a = _conv_i8(_quant(a, s2), s2)
        if f"{name}/short" in qn.sites:
            short = _conv_i8(in_q, qn.sites[f"{name}/short"])
        else:
            short = h_f
        h_f = torch.clamp(a + short, min=0.0)

    _, hf, wf, _ = h_f.shape
    y = h_f @ qn.head_kernel[0, 0] + qn.head_bias
    y = resize_bilinear(y, hf * 4, wf * 4)
    return torch.softmax(y, dim=-1) if use_softmax else y
