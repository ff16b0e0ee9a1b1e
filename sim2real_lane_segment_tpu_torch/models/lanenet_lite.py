"""LaneNetLite, the serving student: eval forward, NCHW.

Counterpart of ``sim2real_lane_segment_tpu.models.lanenet_lite``:
- two stride-2 ``ConvBN`` stem convs, so most of the work runs at /4;
- a residual body of 3x3 convs at C = 64..128, dilated for context, with
  a 1x1 shortcut conv where the width changes;
- a 1x1 class head at /4, then a x4 bilinear upsample (and softmax).

Submodules carry the Flax module names (``featureExtractor.ConvBN_0.
Conv_0``, ``featureExtractor.ResBlock_2.Conv_1``, ``classifier.head`` ...)
so that ``models.flax_import`` maps a Flax tree onto the state dict by
path.  Rounding follows the Flax modules: the convs run in the policy's
compute dtype, BatchNorm and the residual add in float32.

Flax ``padding="SAME"`` is asymmetric for a strided conv: a 3x3 stride-2
conv over an even size pads (0, 1), not (1, 1), so every conv pads
explicitly with ``same_pad``.  The upsample is ``jax.image.resize(...,
"bilinear")``, which for a x4 upsample is ``F.interpolate(mode=
"bilinear", align_corners=False)``; its backward is two products with
the interpolation matrices, so that a train step repeats bit for bit on a
card (``F.interpolate``'s own backward adds with atomics).

Train mode (``model(x, train=True)``) follows ``model.apply(train=True,
mutable=["batch_stats"])``, as the FC-DenseNet's does: BatchNorm
normalizes with the float32 batch statistics and returns the running
update (momentum 0.9, the biased batch variance) instead of writing it
(``models.tiramisu.bn_train``).  The call interface is the FC-DenseNet's,
so the supervised and MME trainers take either model: ``model(x,
train=True, masks=...)`` returns ``(out, updates)``, and
``featureExtractor(x, updates, masks)`` and ``classifier(feats,
use_softmax=...)`` run the two halves.  LaneNetLite has no dropout: its
mask list is empty.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..ops.augment import AugmentConfig, eval_batch
from ..ops.resize import upsample_matrix
from .tiramisu import bn_train

EPS = 1e-5


def same_pad(size: int, k: int, s: int, d: int) -> tuple[int, int]:
    """Flax/XLA 'SAME' padding (asymmetric for strided convs)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
              dilation: int = 1) -> torch.Tensor:
    """NCHW conv with Flax 'SAME' (zero) padding."""
    k = weight.shape[-1]
    ph = same_pad(x.shape[2], k, stride, dilation)
    pw = same_pad(x.shape[3], k, stride, dilation)
    if ph != (0, 0) or pw != (0, 0):
        x = F.pad(x, (*pw, *ph))
    return F.conv2d(x, weight, stride=stride, dilation=dilation)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, train: dict | None,
        name: str) -> torch.Tensor:
    """BatchNorm in float32: running statistics, or with ``train`` (the
    running-update dict) the batch statistics, recorded under ``name``."""
    if train is not None:
        return bn_train(bn, x, train, name)
    return F.batch_norm(x.to(torch.float32), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, False, 0.0, bn.eps)


def _conv(conv: nn.Conv2d, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return conv_same(x.to(cd), conv.weight.to(cd), conv.stride[0],
                     conv.dilation[0])


class ConvBN(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, stride=stride,
                                dilation=dilation, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=EPS)

    def forward(self, x: torch.Tensor, train: dict | None = None,
                name: str = "") -> torch.Tensor:
        cd = self.policy.compute_dtype
        return torch.relu(_bn(self.BatchNorm_0, _conv(self.Conv_0, x, cd),
                              train, f"{name}.BatchNorm_0")).to(cd)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, dilation: int = 1,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.ConvBN_0 = ConvBN(in_channels, features, dilation=dilation,
                               policy=policy)
        self.Conv_0 = nn.Conv2d(features, features, 3, dilation=dilation,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=EPS)
        if in_channels != features:
            self.Conv_1 = nn.Conv2d(in_channels, features, 1, bias=False)

    def forward(self, x: torch.Tensor, train: dict | None = None,
                name: str = "") -> torch.Tensor:
        cd = self.policy.compute_dtype
        h = self.ConvBN_0(x, train, f"{name}.ConvBN_0")
        h = _bn(self.BatchNorm_0, _conv(self.Conv_0, h, cd), train,
                f"{name}.BatchNorm_0")
        if hasattr(self, "Conv_1"):
            x = _conv(self.Conv_1, x, cd)
        return torch.relu(h + x.to(h.dtype)).to(cd)


class LaneNetLiteFeatures(nn.Module):
    """Stem + residual body: frames -> (C, H/4, W/4) features."""

    def __init__(self, stem: Sequence[int] = (32, 64),
                 body: Sequence[tuple] = ((64, 1), (64, 1), (96, 2), (96, 4),
                                          (128, 1)),
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        c = 3
        for i, f in enumerate(stem):
            setattr(self, f"ConvBN_{i}", ConvBN(c, f, stride=2, policy=policy))
            c = f
        for i, (f, d) in enumerate(body):
            setattr(self, f"ResBlock_{i}", ResBlock(c, f, dilation=d,
                                                    policy=policy))
            c = f
        self.out_channels = c

    def forward(self, x: torch.Tensor, train: dict | None = None,
                masks=None) -> torch.Tensor:
        """``train``: the running-update dict of a train-mode forward (None:
        eval mode).  ``masks`` (the FC-DenseNet's dropout masks) is
        accepted for the shared interface; LaneNetLite has no dropout."""
        x = x.to(self.policy.compute_dtype)
        for name, m in self.named_children():
            x = m(x) if train is None else m(x, train,
                                             f"featureExtractor.{name}")
        return x


class LaneNetLiteClassifier(nn.Module):
    """1x1 class head at /4 resolution + bilinear x4 + softmax."""

    def __init__(self, in_channels: int, n_classes: int = 4,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.head = nn.Conv2d(in_channels, n_classes, 1)

    def forward(self, x: torch.Tensor, *,
                use_softmax: bool = True) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x = F.conv2d(x.to(cd), self.head.weight.to(cd),
                     self.head.bias.to(cd)).to(torch.float32)
        x = upsample4(x)
        return torch.softmax(x, dim=1) if use_softmax else x


class _Upsample4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.size = y.shape[2:]
        return F.interpolate(y, size=(y.shape[2] * 4, y.shape[3] * 4),
                             mode="bilinear", align_corners=False,
                             antialias=False)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.size
        return (upsample_matrix(h, 4, g.device).t()
                @ (g @ upsample_matrix(w, 4, g.device)))


def upsample4(y: torch.Tensor) -> torch.Tensor:
    """x4 bilinear upsample of NCHW float32 maps (``jax.image.resize``).
    The backward is the transposed interpolation as two matrix products,
    which sum in a fixed order."""
    return _Upsample4.apply(y)


class LaneNetLite(nn.Module):
    """featureExtractor/classifier split matching the FC-DenseNet module
    layout.  ``forward`` takes (N, 3, H, W) float32 and returns (N,
    n_classes, 4*ceil(ceil(H/2)/2), ...) float32 probabilities (or logits
    with ``use_softmax=False``)."""

    def __init__(self, n_classes: int = 4, stem: Sequence[int] = (32, 64),
                 body: Sequence[tuple] = ((64, 1), (64, 1), (96, 2), (96, 4),
                                          (128, 1)),
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.n_classes = n_classes
        self.stem = tuple(stem)
        self.body = tuple(tuple(b) for b in body)
        self.policy = policy
        self.featureExtractor = LaneNetLiteFeatures(stem, body, policy)
        self.classifier = LaneNetLiteClassifier(
            self.featureExtractor.out_channels, n_classes, policy)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                use_softmax: bool = True, masks=None):
        if not train:
            return self.classifier(self.featureExtractor(x),
                                   use_softmax=use_softmax)
        updates: dict = {}
        x = self.featureExtractor(x, updates, masks)
        return self.classifier(x, use_softmax=use_softmax), updates


@torch.inference_mode()
def serve_apply(model: LaneNetLite, images_u8: torch.Tensor,
                cfg: AugmentConfig | None = None) -> torch.Tensor:
    """Serving forward: uint8 (N, H, W, 3) frames -> uint8 (N, h, w) class
    maps.  The head is an einsum straight into NCHW, then the upsample and
    the argmax run channel-first, as the JAX ``serve_apply``."""
    x, _ = eval_batch(images_u8, None, cfg or AugmentConfig(),
                      with_labels=False)
    feats = model.featureExtractor(x.permute(0, 3, 1, 2))
    cd = model.policy.compute_dtype
    head = model.classifier.head
    w = head.weight[:, :, 0, 0].to(cd)
    y = torch.einsum("bchw,oc->bohw", feats, w) \
        + head.bias.to(cd)[None, :, None, None]
    return torch.argmax(upsample4(y.to(torch.float32)), dim=1).to(
        torch.uint8)
