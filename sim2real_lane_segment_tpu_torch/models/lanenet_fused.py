"""LaneNetLite int8 serving through kernel K6.

Counterpart of the JAX package's ``models/lanenet_pallas.py``
(``pallas_int8_forward``, ``pallas_int8_serve``): the two stride-2 stem
convs run on the exact int8 path of ``models.lanenet_int8`` (as the JAX
function keeps them in XLA), then the residual body and the 1x1 head run
in ``kernels.int8_body`` on rows of pixels ``[B, h*w, C]``, the natural
reshape of the NHWC stem output.  The x4 upsample and the argmax run
channel-first, as in ``models.lanenet_lite.serve_apply``.

The sites are packed for the kernel once per ``QuantizedLaneNet``
(``fold_body``, cached on ``qn.body``).
"""
from __future__ import annotations

import torch

from ..kernels.int8_body import Int8Body, conv_spec, int8_body
from ..ops.augment import AugmentConfig, eval_batch
from .lanenet_int8 import QuantizedLaneNet, _graph, stem_forward
from .lanenet_lite import upsample4


def fold_body(qn: QuantizedLaneNet) -> Int8Body:
    """The body's sites packed for K6: per ResBlock (conv1, conv2,
    shortcut or None), and the head as [C, n] f32."""
    if qn.body is None:
        blocks = []
        for name, _ in _graph(qn.model)[1]:
            short = qn.sites.get(f"{name}/short")
            blocks.append((
                conv_spec(f"{name}/conv1", qn.sites[f"{name}/conv1"]),
                conv_spec(f"{name}/conv2", qn.sites[f"{name}/conv2"]),
                None if short is None else conv_spec(f"{name}/short", short)))
        qn.body = Int8Body(blocks, qn.head_kernel[0, 0].contiguous(),
                           qn.head_bias.contiguous())
    return qn.body


def stem_rows(qn: QuantizedLaneNet, x_norm: torch.Tensor):
    """Normalized float NHWC input -> (K6's input, the f32 stem output as
    rows [B, h*w, C], h, w)."""
    h_f = stem_forward(qn, x_norm)
    b, hh, ww, c = h_f.shape
    return h_f.reshape(b, hh * ww, c).contiguous(), hh, ww


@torch.no_grad()
def fused_int8_forward(qn: QuantizedLaneNet,
                       x_norm: torch.Tensor) -> torch.Tensor:
    """Normalized float NHWC input -> NCHW /4-resolution logits, the
    pre-upsample logits of ``int8_apply``; the body is K6 on a CUDA
    tensor, its plain version on a CPU one."""
    rows, hh, ww = stem_rows(qn, x_norm)
    logits = int8_body(rows, fold_body(qn), hh, ww)
    return logits.reshape(rows.shape[0], hh, ww, -1).permute(0, 3, 1, 2)


@torch.no_grad()
def fused_int8_serve(qn: QuantizedLaneNet, images_u8: torch.Tensor, *,
                     cfg: AugmentConfig | None = None) -> torch.Tensor:
    """uint8 (N, H, W, 3) frames -> uint8 (N, h, w) class maps through
    K6."""
    x, _ = eval_batch(images_u8, None, cfg or AugmentConfig(),
                      with_labels=False)
    y = fused_int8_forward(qn, x)
    return torch.argmax(upsample4(y), dim=1).to(torch.uint8)
