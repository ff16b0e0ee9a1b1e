"""Learning demos (reference rightLaneDatagen/learning/): behaviour-cloning
imitation (``imitation.py``) and DDPG reinforcement learning
(``ddpg.py``).

Counterpart of the JAX package's ``learning/``.  The policies are the
JAX package's Flax CNNs as ``nn.Module``s under the Flax names
(``Conv_i``, ``Dense_i``), so ``models.flax_import.policy_state_dict_
from_flax`` carries Flax weights across.  They take (B, H, W, 3) frames
with values in [0, 255] (uint8 or float), as the Flax modules do, and
reproduce Flax's layout where it shows: ``SAME`` padding, which is
asymmetric for these 4x4 kernels (60 -> 30 -> 15 -> 8 rows pads the
15-row plane 1 on top and 2 below), and the NHWC flatten before the
first dense layer.  Parameters start as Flax's do: LeCun-normal
(truncated) kernels and zero biases, from a seeded generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def same_out(size: int, stride: int) -> int:
    """A plane's size after a ``SAME`` convolution at ``stride``."""
    return -(-size // stride)


class SameConv2d(nn.Conv2d):
    """``flax.linen.Conv(padding="SAME")``: pad total (out - 1) * stride +
    k - in, the smaller half before, then a valid convolution."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(reversed(x.shape[-2:]),
                              reversed(self.kernel_size),
                              reversed(self.stride)):
            total = max((same_out(size, s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


def frames_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) frames in [0, 255] -> (B, 3, H, W) float32 in [0, 1]."""
    return (x.to(torch.float32) / 255.0).permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W * C) in Flax's (NHWC) order."""
    return x.permute(0, 2, 3, 1).flatten(1)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisers on every conv and dense layer: kernels
    LeCun normal (variance 1 / fan_in, truncated at two deviations),
    biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # the deviation of a standard normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)


def load_policy(path: str, model: nn.Module) -> nn.Module:
    """Weights into ``model`` in place: the port's ``.pt`` state dict, or
    a JAX CLI's ``.msgpack`` params (``serialization.to_bytes``)."""
    if path.endswith(".msgpack"):
        from ..models.flax_import import policy_state_dict_from_flax
        from ..train.checkpoint import flatten, read_msgpack

        with open(path, "rb") as f:
            flat = flatten(read_msgpack(f.read()))
        sd = policy_state_dict_from_flax(flat, model)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd)
    return model
