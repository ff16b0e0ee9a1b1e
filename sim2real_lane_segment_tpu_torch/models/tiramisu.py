"""FC-DenseNet ("Tiramisu") segmentation CNN, eval forward, NCHW.

Counterpart of ``sim2real_lane_segment_tpu.models.tiramisu``.  Submodules
carry the Flax module names (``featureExtractor.denseDown0.DenseLayer_0.
BatchNorm_0`` ...) so that ``models.flax_import`` maps a Flax tree onto
the state dict by path.

Architecture semantics (reference layers.py:5-86):
- DenseLayer     = BN -> ReLU -> 3x3 conv(bias) [-> Dropout2d in training].
- DenseBlock     = concat growth; the ``upsample`` variant returns only the
  newly produced features.
- TransitionDown = BN -> ReLU -> 1x1 conv -> 2x2 maxpool (floor).
- TransitionUp   = 3x3 stride-2 VALID transposed conv -> floor center-crop
  to the skip's size -> concat with the skip.

Rounding follows the Flax modules: BatchNorm runs in float32, the conv
operands and output are in the policy's compute dtype, and the bias is
added in that dtype.  Only inference is ported: train mode (batch-stat
BatchNorm, Dropout2d, gradient reversal) belongs to the training slice and
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy

EPS = 1e-5


def _train_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "FCDenseNet train mode (batch-stat BatchNorm, Dropout2d, "
        "gradient reversal) is not yet ported; only train=False runs")


def bn_relu(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Running-stat BatchNorm in float32, then ReLU."""
    y = F.batch_norm(x.to(torch.float32), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, False, 0.0, bn.eps)
    return torch.relu(y)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.BatchNorm_0 = nn.BatchNorm2d(in_channels, eps=EPS)
        self.Conv_0 = nn.Conv2d(in_channels, growth_rate, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        a = bn_relu(self.BatchNorm_0, x).to(cd)
        return F.conv2d(a, self.Conv_0.weight.to(cd), self.Conv_0.bias.to(cd),
                        padding=1)


class DenseBlock(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, n_layers: int,
                 upsample: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.upsample = upsample
        self.n_layers = n_layers
        for j in range(n_layers):
            self.add_module(f"DenseLayer_{j}", DenseLayer(
                in_channels + j * growth_rate, growth_rate, policy))

    def layers(self) -> list[DenseLayer]:
        return [getattr(self, f"DenseLayer_{j}") for j in range(self.n_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        new_features = []
        for layer in self.layers():
            out = layer(x)
            x = torch.cat([x, out.to(x.dtype)], dim=1)
            new_features.append(out)
        if self.upsample:
            return torch.cat(new_features, dim=1)
        return x


class TransitionDown(nn.Module):
    def __init__(self, channels: int, policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.BatchNorm_0 = nn.BatchNorm2d(channels, eps=EPS)
        self.Conv_0 = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        a = bn_relu(self.BatchNorm_0, x).to(cd)
        y = F.conv2d(a, self.Conv_0.weight.to(cd), self.Conv_0.bias.to(cd))
        return F.max_pool2d(y, 2)  # floor division, as Flax's VALID pool


def center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop (N, C, H, W) to (N, C, h, w) around the center (floor offsets)."""
    y0 = (x.shape[2] - h) // 2
    x0 = (x.shape[3] - w) // 2
    return x[:, :, y0:y0 + h, x0:x0 + w]


def transition_up(x: torch.Tensor, conv: nn.ConvTranspose2d, h: int, w: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """stride-2 VALID 3x3 transposed conv in ``dtype`` (+bias in ``dtype``)
    -> center-crop to (h, w)."""
    y = F.conv_transpose2d(x.to(dtype), conv.weight.to(dtype), stride=2)
    y = y + conv.bias.to(dtype)[:, None, None]
    return center_crop(y, h, w)


class TransitionUp(nn.Module):
    def __init__(self, features: int, policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.ConvTranspose_0 = nn.ConvTranspose2d(features, features, 3,
                                                  stride=2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = transition_up(x, self.ConvTranspose_0, skip.shape[2],
                          skip.shape[3], self.policy.compute_dtype)
        return torch.cat([y, skip.to(y.dtype)], dim=1)


class FCDenseNetFeatureExtractor(nn.Module):
    def __init__(self, down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 bottleneck_layers: int = 5, growth_rate: int = 16,
                 out_chans_first_conv: int = 48,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.down_blocks = tuple(down_blocks)
        self.up_blocks = tuple(up_blocks)
        self.bottleneck_layers = bottleneck_layers
        self.growth_rate = growth_rate
        self.policy = policy
        g = growth_rate
        self.firstconv = nn.Conv2d(3, out_chans_first_conv, 3, padding=1)
        # channel bookkeeping mirrors reference tiramisu.py:27-87
        cur = out_chans_first_conv
        skips = []
        for i, n in enumerate(self.down_blocks):
            self.add_module(f"denseDown{i}",
                            DenseBlock(cur, g, n, False, policy))
            cur += g * n
            skips.insert(0, cur)
            self.add_module(f"transDown{i}", TransitionDown(cur, policy))
        self.bottleneck = DenseBlock(cur, g, bottleneck_layers, True, policy)
        prev = g * bottleneck_layers
        for i, n in enumerate(self.up_blocks):
            self.add_module(f"transUp{i}", TransitionUp(prev, policy))
            last = i == len(self.up_blocks) - 1
            self.add_module(f"denseUp{i}", DenseBlock(
                prev + skips[i], g, n, not last, policy))
            # the last up block returns its whole concat, the others only
            # their new features
            prev = prev + skips[i] + g * n if last else g * n
        self.feature_channels = prev

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """x: (N, 3, H, W) float32 -> L2-normalized features, float32."""
        if train:
            raise _train_not_ported()
        cd = self.policy.compute_dtype
        fc = self.firstconv
        out = F.conv2d(x.to(cd), fc.weight.to(cd), fc.bias.to(cd), padding=1)
        skips = []
        for i in range(len(self.down_blocks)):
            out = getattr(self, f"denseDown{i}")(out)
            skips.append(out)
            out = getattr(self, f"transDown{i}")(out)
        out = self.bottleneck(out)
        for i in range(len(self.up_blocks)):
            out = getattr(self, f"transUp{i}")(out, skips.pop())
            out = getattr(self, f"denseUp{i}")(out)
        # per-pixel L2 normalization (reference tiramisu.py:105,
        # F.normalize: x / max(||x||_2, 1e-12))
        out = out.to(torch.float32)
        norm = torch.sqrt(torch.sum(out * out, dim=1, keepdim=True))
        return out / torch.clamp(norm, min=1e-12)


class FCDenseNetClassifier(nn.Module):
    def __init__(self, in_channels: int, n_classes: int,
                 temperature: float = 0.05, kernel_size: int = 1,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.temperature = temperature
        self.kernel_size = kernel_size
        self.policy = policy
        self.finalConv = nn.Conv2d(in_channels, n_classes, kernel_size,
                                   padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, *,
                use_softmax: bool = True) -> torch.Tensor:
        cd = self.policy.compute_dtype
        c = self.finalConv
        x = F.conv2d(x.to(cd), c.weight.to(cd), c.bias.to(cd),
                     padding=self.kernel_size // 2)
        x = x.to(torch.float32) / self.temperature
        if use_softmax:
            x = torch.softmax(x, dim=1)
        return x


class FCDenseNet(nn.Module):
    """Feature extractor + classifier, reference tiramisu.py:128-147.

    ``forward`` takes (N, 3, H, W) float32 and returns (N, n_classes, H, W)
    float32 probabilities (or logits with ``use_softmax=False``).
    """

    def __init__(self, n_classes: int = 12,
                 down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 bottleneck_layers: int = 5, growth_rate: int = 16,
                 out_chans_first_conv: int = 48, kernel_size: int = 1,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.n_classes = n_classes
        self.down_blocks = tuple(down_blocks)
        self.up_blocks = tuple(up_blocks)
        self.bottleneck_layers = bottleneck_layers
        self.growth_rate = growth_rate
        self.kernel_size = kernel_size
        self.policy = policy
        self.featureExtractor = FCDenseNetFeatureExtractor(
            down_blocks, up_blocks, bottleneck_layers, growth_rate,
            out_chans_first_conv, policy)
        self.classifier = FCDenseNetClassifier(
            self.featureExtractor.feature_channels, n_classes,
            kernel_size=kernel_size, policy=policy)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                use_softmax: bool = True) -> torch.Tensor:
        x = self.featureExtractor(x, train=train)
        return self.classifier(x, use_softmax=use_softmax)


# ---------------------------------------------------------------------------
# factories (reference tiramisu.py:150-194)
# ---------------------------------------------------------------------------

def fcdensenet57(n_classes, kernel_size=1, policy=DEFAULT_POLICY):
    return FCDenseNet(n_classes=n_classes, down_blocks=(4,) * 5,
                      up_blocks=(4,) * 5, bottleneck_layers=4,
                      growth_rate=12, out_chans_first_conv=48,
                      kernel_size=kernel_size, policy=policy)


def fcdensenet67(n_classes, policy=DEFAULT_POLICY):
    return FCDenseNet(n_classes=n_classes, down_blocks=(5,) * 5,
                      up_blocks=(5,) * 5, bottleneck_layers=5,
                      growth_rate=16, out_chans_first_conv=48, policy=policy)


def fcdensenet103(n_classes, policy=DEFAULT_POLICY):
    return FCDenseNet(n_classes=n_classes, down_blocks=(4, 5, 7, 10, 12),
                      up_blocks=(12, 10, 7, 5, 4), bottleneck_layers=15,
                      growth_rate=16, out_chans_first_conv=48, policy=policy)
