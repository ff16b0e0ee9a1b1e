"""The legacy encoder-decoder segmentation CNN (arch ``encdec``), NCHW.

Counterpart of ``sim2real_lane_segment_tpu.models.encdec`` (the
reference's first-phase model, rightLaneNetwork/models/EncDecNet.py): per
level a ``ConvBlock`` (conv -> activation -> BatchNorm -> dropout, BN
after the nonlinearity as in the reference) then a 3x3 stride-2 max-pool
on the way down, a ``ConvBlock`` then a x2 bilinear upsample on the way
up, and a 1x1 classifier with softmax.  Submodules carry the Flax names
(``enc0.Conv_0``, ``enc0.BatchNorm_0``, ``enc0.prelu_alpha``,
``classifier``) so that ``models.flax_import`` maps a Flax tree onto the
state dict.

The upsample is ``jax.image.resize(..., "bilinear")`` (half-pixel centers,
clamped at the border; the JAX docstring's ``align_corners=True`` does
not hold), written out as two products with the interpolation matrices
(``ops.resize.upsample_matrix``): its backward is two more products,
which sum in a fixed order on a card, where ``F.interpolate``'s backward
adds with atomics.

Train mode (``model(x, train=True, masks=...)``) returns ``(out,
updates)`` like the FC-DenseNet's: BatchNorm with the float32 batch
statistics (``tiramisu.bn_train``), and dropout elementwise (Flax
``nn.Dropout`` without broadcast dims) with masks as operands, one
[B, C*h*w] block per ConvBlock in order (``dropout_elements``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..ops.resize import upsample_matrix
from .tiramisu import bn_train

EPS = 1e-5

ACTIVATIONS: dict[str, Callable | None] = {
    "relu": torch.relu,
    "prelu": None,  # a learned slope, ConvBlock.prelu_alpha
    "leakyRelu": lambda x: F.leaky_relu(x, 0.01),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "none": lambda x: x,
}


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of (N, C, H, W) as ``jax.image.resize``,
    computed in float32 and returned in ``x``'s dtype."""
    h, w = x.shape[2], x.shape[3]
    ah = upsample_matrix(h, 2, x.device)
    aw = upsample_matrix(w, 2, x.device)
    return (ah @ (x.to(torch.float32) @ aw.t())).to(x.dtype)


def _pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch ``MaxPool2d(k, stride=2, padding=k // 2)``, Flax's max_pool
    over -inf padding."""
    return F.max_pool2d(x, k, stride=2, padding=k // 2)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, activation: str = "relu",
                 batch_norm: bool = True, dropout: float = 0.3,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        if not 0 <= dropout < 1:
            raise ValueError(f"dropout must be in [0,1), got {dropout}")
        self.activation = activation
        self.dropout = dropout
        self.policy = policy
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size, stride,
                                padding=kernel_size // 2)
        if activation == "prelu":
            self.prelu_alpha = nn.Parameter(torch.tensor(0.25))
        self.BatchNorm_0 = (nn.BatchNorm2d(features, eps=EPS) if batch_norm
                            else None)

    def forward(self, x: torch.Tensor, train: dict | None = None,
                name: str = "", mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        cd = self.policy.compute_dtype
        c = self.Conv_0
        x = F.conv2d(x.to(cd), c.weight.to(cd), c.bias.to(cd),
                     stride=c.stride, padding=c.padding)
        if self.activation == "prelu":
            x = torch.where(x >= 0, x, self.prelu_alpha.to(x.dtype) * x)
        else:
            x = ACTIVATIONS[self.activation](x)
        bn = self.BatchNorm_0
        if bn is not None:
            x = (F.batch_norm(x.to(torch.float32), bn.running_mean,
                              bn.running_var, bn.weight, bn.bias, False, 0.0,
                              bn.eps) if train is None
                 else bn_train(bn, x, train, f"{name}.BatchNorm_0")).to(cd)
        if train is not None and mask is not None:
            x = x * mask.reshape(x.shape).to(x.dtype)
        return x


class EncDecNet(nn.Module):
    """``forward`` takes (N, 3, H, W) float32 and returns (N, n_classes,
    H', W') float32 probabilities (or logits with ``use_softmax=False``);
    H' is H for H a multiple of 2**n_levels."""

    def __init__(self, n_features: int = 64, n_levels: int = 3,
                 kernel_size: int = 3, activation: str = "relu",
                 batch_norm: bool = True, dropout: float = 0.3,
                 n_classes: int = 2, policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        if n_features < 1 or n_levels < 1:
            raise ValueError("n_features and n_levels must be >= 1")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.n_levels = n_levels
        self.kernel_size = kernel_size
        self.dropout_rate = dropout
        self.n_classes = n_classes
        self.policy = policy
        kw = dict(kernel_size=kernel_size, activation=activation,
                  batch_norm=batch_norm, dropout=dropout, policy=policy)
        cur, feat = 3, n_features
        for i in range(n_levels):
            self.add_module(f"enc{i}", ConvBlock(cur, feat, **kw))
            cur, feat = feat, feat * 2
        feat //= 2
        for i in range(n_levels):
            self.add_module(f"dec{i}", ConvBlock(cur, feat, **kw))
            cur, feat = feat, max(feat // 2, 1)
        self.classifier = nn.Conv2d(cur, n_classes, 1)

    def blocks(self) -> list[tuple[str, ConvBlock]]:
        return ([(f"enc{i}", getattr(self, f"enc{i}"))
                 for i in range(self.n_levels)]
                + [(f"dec{i}", getattr(self, f"dec{i}"))
                   for i in range(self.n_levels)])

    def dropout_elements(self, size) -> list[int]:
        """The elements per sample of each ConvBlock's dropout mask for an
        input of ``size`` (h, w); none without dropout."""
        if self.dropout_rate == 0.0:
            return []
        if size is None:
            raise ValueError("EncDecNet's dropout masks need the input size")
        h, w = size
        k = self.kernel_size
        out = []
        for name, block in self.blocks():
            out.append(block.Conv_0.out_channels * h * w)
            if name.startswith("enc"):
                h, w = (h + 2 * (k // 2) - k) // 2 + 1, \
                    (w + 2 * (k // 2) - k) // 2 + 1
            else:
                h, w = 2 * h, 2 * w
        return out

    def forward(self, x: torch.Tensor, *, train: bool = False,
                use_softmax: bool = True, masks=None):
        updates: dict | None = {} if train else None
        it = iter(masks) if (train and masks is not None) else None
        x = x.to(self.policy.compute_dtype)
        for name, block in self.blocks():
            x = block(x, updates, name, next(it) if it is not None else None)
            x = (_pool(x, self.kernel_size) if name.startswith("enc")
                 else upsample_bilinear_2x(x))
        cd = self.policy.compute_dtype
        c = self.classifier
        x = F.conv2d(x, c.weight.to(cd), c.bias.to(cd)).to(torch.float32)
        x = torch.softmax(x, dim=1) if use_softmax else x
        return (x, updates) if train else x
