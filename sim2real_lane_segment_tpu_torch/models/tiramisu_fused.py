"""FC-DenseNet inference forward with fused dense blocks (K4).

Counterpart of the JAX package's ``models/tiramisu_pallas.py``:
``fold_block_params`` / ``fold_transition`` fold each BatchNorm into a
per-channel scale and shift (f32, eps 1e-5) and lay the conv weights out
for the kernel, and ``fused_apply`` is ``pallas_apply``.  Each of the
model's dense blocks runs as ``kernels.dense_block.dense_block``; the glue
between blocks stays plain PyTorch, as XLA ran it outside the Pallas
kernel: the first conv, the 2x2 floor max-pool after each TransitionDown,
the stride-2 VALID transposed conv with its floor center-crop, and the
classifier tail when it cannot be fused (``kernel_size != 1`` or more than
8 classes).

Rounding follows the JAX fused path: first conv in the compute dtype with
the bias added in that dtype; dense layers add the f32 bias before
rounding; TransitionDown rounds before adding the bias.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.dense_block import (FoldedClassifier, FoldedLayer,
                                   FoldedTransition, dense_block, pad_growth,
                                   takes_mma_dense)
from .tiramisu import (EPS, DenseBlock, FCDenseNet, TransitionDown,
                       transition_up)


def _fold_bn(bn) -> tuple[torch.Tensor, torch.Tensor]:
    scale = bn.weight.detach().float() * torch.rsqrt(
        bn.running_var.float() + EPS)
    shift = bn.bias.detach().float() - bn.running_mean.float() * scale
    return scale.contiguous(), shift.contiguous()


@torch.no_grad()
def fold_block_params(block: DenseBlock, dtype: torch.dtype) -> list[FoldedLayer]:
    """Per layer: BN folded to (scale, shift), conv OIHW [g, c_j, 3, 3] ->
    [c_j, 9, g] in ``dtype`` (tap = ky*3+kx; where the layer takes the
    tensor cores, in the padded layout they read: ``pad_growth``), bias
    f32."""
    folded = []
    for layer in block.layers():
        scale, shift = _fold_bn(layer.BatchNorm_0)
        w = layer.Conv_0.weight.detach()  # [g, c_j, 3, 3]
        g, k = w.shape[:2]
        rows = w.permute(1, 2, 3, 0).reshape(k, 9, g)
        wk = (pad_growth(rows, dtype) if takes_mma_dense(dtype, g)
              else rows.to(dtype).contiguous())
        folded.append(FoldedLayer(scale, shift, wk,
                                  layer.Conv_0.bias.detach().float()))
    return folded


@torch.no_grad()
def fold_transition(td: TransitionDown, dtype: torch.dtype) -> FoldedTransition:
    """TransitionDown -> kernel epilogue form: BN folded, 1x1 conv as
    [C_in, C_out] in ``dtype``."""
    scale, shift = _fold_bn(td.BatchNorm_0)
    w = td.Conv_0.weight.detach()[:, :, 0, 0].t().to(dtype).contiguous()
    return FoldedTransition(scale, shift, w, td.Conv_0.bias.detach().float())


@torch.no_grad()
def fold_classifier(model: FCDenseNet, dtype: torch.dtype) -> FoldedClassifier | None:
    """The classifier tail padded to 8 rows, or None where the kernel does
    not take it (``kernel_size != 1`` or more than 8 classes)."""
    conv = model.classifier.finalConv
    n_cls = conv.weight.shape[0]
    if model.kernel_size != 1 or n_cls > 8:
        return None
    w = torch.zeros(8, conv.weight.shape[1], dtype=dtype,
                    device=conv.weight.device)
    w[:n_cls] = conv.weight[:, :, 0, 0].to(dtype)
    b = torch.zeros(8, dtype=torch.float32, device=conv.weight.device)
    b[:n_cls] = conv.bias.float()
    return FoldedClassifier(w, b, 1.0 / model.classifier.temperature)


class FoldedModel(NamedTuple):
    """Everything ``fused_apply`` feeds the kernels, folded once per set of
    weights: block name -> layers, ``transDown{i}`` -> transition, and the
    classifier tail (or None)."""
    blocks: dict
    transitions: dict
    classifier: FoldedClassifier | None


@torch.no_grad()
def fold_model(model: FCDenseNet) -> FoldedModel:
    dtype = model.policy.compute_dtype
    fe = model.featureExtractor
    names = ([f"denseDown{i}" for i in range(len(model.down_blocks))]
             + ["bottleneck"]
             + [f"denseUp{i}" for i in range(len(model.up_blocks))])
    blocks = {n: fold_block_params(getattr(fe, n), dtype) for n in names}
    tds = {f"transDown{i}": fold_transition(getattr(fe, f"transDown{i}"),
                                            dtype)
           for i in range(len(model.down_blocks))}
    return FoldedModel(blocks, tds, fold_classifier(model, dtype))


@torch.no_grad()
def fused_apply(model: FCDenseNet, x: torch.Tensor,
                folded: FoldedModel | None = None, *,
                use_softmax: bool = True, block_fn=dense_block) -> torch.Tensor:
    """Inference forward of an ``FCDenseNet`` with fused dense blocks.

    x: (N, 3, H, W) float32 on the model's device.  Matches
    ``model(x, use_softmax=...)`` and the JAX ``pallas_apply``.  ``folded``
    is ``fold_model(model)``, computed here when not given.  ``block_fn``
    runs each dense block; it is ``dense_block`` except where a caller
    records the blocks' inputs to hold the kernels against their plain
    versions.
    """
    if folded is None:
        folded = fold_model(model)
    dtype = model.policy.compute_dtype
    fe = model.featureExtractor
    fc = fe.firstconv
    cur = F.conv2d(x.to(dtype), fc.weight.to(dtype), padding=1)
    cur = cur + fc.bias.to(dtype)[:, None, None]

    skips = []
    for i in range(len(model.down_blocks)):
        cur, td_pre = block_fn([cur], folded.blocks[f"denseDown{i}"], c_lo=0,
                               td=folded.transitions[f"transDown{i}"])
        skips.append(cur)
        cur = F.max_pool2d(td_pre, 2)  # floor, as the VALID reduce_window

    new = block_fn([cur], folded.blocks["bottleneck"], c_lo=cur.shape[1])

    n_cls = model.n_classes
    cls = None
    for i in range(len(model.up_blocks)):
        skip = skips.pop()
        up = transition_up(new, getattr(fe, f"transUp{i}").ConvTranspose_0,
                           skip.shape[2], skip.shape[3], dtype)
        last = i == len(model.up_blocks) - 1
        cls = folded.classifier if last else None
        new = block_fn([up, skip], folded.blocks[f"denseUp{i}"],
                       c_lo=0 if last else up.shape[1] + skip.shape[1],
                       cls=cls)

    if cls is not None:
        logits = new[:, :n_cls]
    else:
        # wide classifier kernels take the plain tail
        feats = new.to(torch.float32)
        norm = torch.clamp(torch.sqrt(torch.sum(feats * feats, dim=1,
                                                keepdim=True)), min=1e-12)
        conv = model.classifier.finalConv
        logits = F.conv2d((feats / norm).to(dtype), conv.weight.to(dtype),
                          padding=model.kernel_size // 2)
        logits = ((logits.to(torch.float32) + conv.bias[:, None, None])
                  / model.classifier.temperature)

    if use_softmax:
        logits = torch.softmax(logits, dim=1)
    return logits
