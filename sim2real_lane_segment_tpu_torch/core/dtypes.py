"""Dtype policy: float32 parameters, bfloat16 compute.

Mirrors ``sim2real_lane_segment_tpu.core.dtypes``: parameters stay
float32, activations and conv operands are fed in bfloat16, outputs are
float32.  ``F32_POLICY`` computes in float32 for parity checks;
``F64_POLICY`` runs the plain modules wholly in float64, as a reference
for the rounding of the float32 paths.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = DTypePolicy()
# Full-f32 policy for parity tests against the reference numerics.
F32_POLICY = DTypePolicy(compute_dtype=torch.float32)
# Float64 reference: every float32 step of the plain modules runs in
# float64 instead (the model's parameters must be float64 too).
F64_POLICY = DTypePolicy(param_dtype=torch.float64,
                         compute_dtype=torch.float64,
                         output_dtype=torch.float64)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or unchanged when it is float64: the steps that
    run in float32 keep a float64 reference run in float64."""
    return x if x.dtype == torch.float64 else x.to(torch.float32)
