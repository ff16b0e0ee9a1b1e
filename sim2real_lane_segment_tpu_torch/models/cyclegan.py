"""CycleGAN ResNet generator and 70x70 PatchGAN discriminator, NCHW.

Counterpart of ``sim2real_lane_segment_tpu.models.cyclegan``, built as
the reference builds them (rightLaneNetwork/utils/sim2real_convert.py
GeneratorResNet, and the PatchGAN it was trained against): each network
is one ``nn.Sequential`` named ``model``, in the reference's layer order,
so a reference ``.pt``/``.pth`` state dict loads with
``load_state_dict`` (keys ``model.1.weight``, ``model.10.block.1.weight``
...).  ``models.flax_import.cyclegan_state_dict_from_flax`` carries the
JAX package's Flax trees onto the same modules.

The layers and their quirks follow the JAX modules:
- the stem and the head reflect-pad by ``channels`` (3) before their 7x7
  convs; residual blocks reflect-pad by 1;
- ``InstanceNorm``: eps 1e-5, no affine, no running statistics; the mean
  and the biased variance are summed in float32 and cast to the
  activations' dtype, then ``(x - mean) * rsqrt(var + eps)`` in it (what
  ``jnp.mean``/``jnp.var`` do for bfloat16);
- the upsample is nearest x2, the head ``tanh`` in float32;
- the discriminator pads its features by (1, 0) at the top and left
  before its 1-channel head, and returns float32.

Convolutions take their operands in the policy's compute dtype (inputs,
weights and bias cast, as Flax's ``nn.Conv(dtype=...)``); parameters are
float32.  ``cli.sim2real_convert`` applies the generator under
``DEFAULT_POLICY``, the trainer under ``F32_POLICY``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy, at_least_f32

EPS = 1e-5


class PolicyConv2d(nn.Conv2d):
    """``nn.Conv2d`` whose operands are cast to ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv2d(x.to(cd), self.weight.to(cd), self.bias.to(cd),
                        self.stride, self.padding)


class InstanceNorm(nn.Module):
    """torch ``InstanceNorm2d`` defaults (eps 1e-5, no affine, no running
    statistics) in the JAX module's arithmetic."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        mean = xf.mean((2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean((2, 3), keepdim=True)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        return (x - mean) * torch.rsqrt(var + EPS)


class TanhF32(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(at_least_f32(x))


class OutputF32(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return at_least_f32(x)


class ResidualBlock(nn.Module):
    def __init__(self, features: int, policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        cd = policy.compute_dtype
        self.block = nn.Sequential(
            nn.ReflectionPad2d(1),
            PolicyConv2d(features, features, 3, compute_dtype=cd),
            InstanceNorm(),
            nn.ReLU(),
            nn.ReflectionPad2d(1),
            PolicyConv2d(features, features, 3, compute_dtype=cd),
            InstanceNorm())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class GeneratorResNet(nn.Module):
    """(N, 3, H, W) in [-1, 1] -> (N, 3, H, W) float32 in [-1, 1]; H and W
    multiples of 4."""

    def __init__(self, channels: int = 3, num_residual_blocks: int = 9,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        cd = policy.compute_dtype
        feat = 64
        layers = [nn.ReflectionPad2d(channels),
                  PolicyConv2d(channels, feat, 7, compute_dtype=cd),
                  InstanceNorm(), nn.ReLU()]
        for _ in range(2):
            layers += [PolicyConv2d(feat, feat * 2, 3, stride=2, padding=1,
                                    compute_dtype=cd),
                       InstanceNorm(), nn.ReLU()]
            feat *= 2
        layers += [ResidualBlock(feat, policy)
                   for _ in range(num_residual_blocks)]
        for _ in range(2):
            layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                       PolicyConv2d(feat, feat // 2, 3, padding=1,
                                    compute_dtype=cd),
                       InstanceNorm(), nn.ReLU()]
            feat //= 2
        layers += [nn.ReflectionPad2d(channels),
                   PolicyConv2d(feat, channels, 7, compute_dtype=cd),
                   TanhF32()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.policy.compute_dtype))


class Discriminator(nn.Module):
    """70x70 PatchGAN: C64-C128-C256-C512 4x4 stride-2 convs (no norm on
    the first), LeakyReLU 0.2, then a 1-channel 4x4 head: (N, 3, H, W) ->
    (N, 1, H/16, W/16) float32 patch scores."""

    def __init__(self, channels: int = 3,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        cd = policy.compute_dtype
        layers, c_in = [], channels
        for i, feat in enumerate((64, 128, 256, 512)):
            layers.append(PolicyConv2d(c_in, feat, 4, stride=2, padding=1,
                                       compute_dtype=cd))
            if i > 0:
                layers.append(InstanceNorm())
            layers.append(nn.LeakyReLU(0.2))
            c_in = feat
        layers += [nn.ZeroPad2d((1, 0, 1, 0)),
                   PolicyConv2d(512, 1, 4, padding=1, compute_dtype=cd),
                   OutputF32()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.policy.compute_dtype))


def convs(model: nn.Module) -> list[PolicyConv2d]:
    """The network's convolutions in the order they are applied."""
    return [m for m in model.modules() if isinstance(m, nn.Conv2d)]
