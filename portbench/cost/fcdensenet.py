"""Operations and bytes of an FC-DenseNet, from the configuration's shapes.

The count does not depend on how the program computes the network. A
convolution's operations are 2 * inputs * outputs * taps per output
pixel (a transposed convolution's per input pixel); BatchNorm, ReLU,
pooling, concatenation and the L2 normalisation are not counted. Bytes
count each operand read once and each result written once: activations
and weights in the compute dtype (bfloat16, 2 bytes), the per-channel
BatchNorm affine and bias in float32, the served logits and the weight
gradients in float32.

``layers`` lists every convolution with its resolution; ``forward_flops``
sums the network's forward for one image. ``serve_kernels`` and
``train_kernels`` give the least time of the work that the program's own
kernels do (the dense layers, the TransitionDowns and the classifier when
serving; the dense layers' and TransitionDowns' forward and backward when
training) at a batch, at the card's peaks.
"""
from __future__ import annotations

import json
import os

ACT, PARAM = 2, 4
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "h100.json")) as _f:
    PEAK = json.load(_f)


def layers(cfg: dict) -> list[dict]:
    """Every convolution: kind, c_in, c_out, taps, (h, w) of its output
    (of its input for a transposed convolution)."""
    h, w, g = cfg["height"], cfg["width"], cfg["growth_rate"]
    cur = cfg["out_chans_first_conv"]
    out = [dict(kind="first", c_in=3, c_out=cur, taps=9, h=h, w=w)]
    skips = []
    for n in cfg["down_blocks"]:
        for j in range(n):
            out.append(dict(kind="dense", c_in=cur + j * g, c_out=g, taps=9,
                            h=h, w=w))
        cur += g * n
        skips.append((cur, h, w))
        out.append(dict(kind="td", c_in=cur, c_out=cur, taps=1, h=h, w=w))
        h, w = h // 2, w // 2
    for j in range(cfg["bottleneck_layers"]):
        out.append(dict(kind="dense", c_in=cur + j * g, c_out=g, taps=9,
                        h=h, w=w))
    prev = g * cfg["bottleneck_layers"]
    for i, n in enumerate(cfg["up_blocks"]):
        out.append(dict(kind="tu", c_in=prev, c_out=prev, taps=9, h=h, w=w))
        c_skip, h, w = skips.pop()
        c0 = prev + c_skip
        for j in range(n):
            out.append(dict(kind="dense", c_in=c0 + j * g, c_out=g, taps=9,
                            h=h, w=w))
        prev = c0 + g * n if i == len(cfg["up_blocks"]) - 1 else g * n
    out.append(dict(kind="classifier", c_in=prev, c_out=cfg["n_classes"],
                    taps=1, h=h, w=w))
    return out


def flops(layer: dict) -> float:
    return 2.0 * layer["c_in"] * layer["c_out"] * layer["taps"] \
        * layer["h"] * layer["w"]


def forward_flops(cfg: dict) -> float:
    """One image's forward."""
    return sum(flops(x) for x in layers(cfg))


def _weights(x: dict) -> int:
    return x["c_in"] * x["taps"] * x["c_out"] * ACT \
        + (2 * x["c_in"] + x["c_out"]) * PARAM


def _least(flop: float, nbytes: float) -> float:
    return max(flop / PEAK["bf16_flops_per_s"],
               nbytes / PEAK["hbm_bytes_per_s"])


def serve_kernels(cfg: dict, batch: int) -> float:
    """Least seconds of the served forward's dense layers,
    TransitionDowns (before the pool) and classifier at ``batch``."""
    t = 0.0
    for x in layers(cfg):
        if x["kind"] not in ("dense", "td", "classifier"):
            continue
        px = batch * x["h"] * x["w"]
        out_bytes = PARAM if x["kind"] == "classifier" else ACT
        nbytes = px * x["c_in"] * ACT + _weights(x) + px * x["c_out"] \
            * out_bytes
        t += _least(batch * flops(x), nbytes)
    return t


def train_kernels(cfg: dict, batch: int) -> float:
    """Least seconds of one step's dense-layer and TransitionDown
    forwards (x, w -> y) and backwards (x, dy, w -> dx, dw) at
    ``batch``."""
    t = 0.0
    for x in layers(cfg):
        if x["kind"] not in ("dense", "td"):
            continue
        px = batch * x["h"] * x["w"]
        a_in, a_out = px * x["c_in"] * ACT, px * x["c_out"] * ACT
        f = batch * flops(x)
        t += _least(f, a_in + _weights(x) + a_out)
        t += _least(2 * f, a_in + a_out + _weights(x) + a_in
                    + x["c_in"] * x["taps"] * x["c_out"] * PARAM)
    return t
