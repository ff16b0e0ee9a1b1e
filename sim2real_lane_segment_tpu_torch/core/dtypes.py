"""Dtype policy: float32 parameters, bfloat16 compute.

Mirrors ``sim2real_lane_segment_tpu.core.dtypes``: parameters stay
float32, activations and conv operands are fed in bfloat16, outputs are
float32.  ``F32_POLICY`` computes in float32 for parity checks.
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
