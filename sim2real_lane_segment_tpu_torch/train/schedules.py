"""Learning-rate schedules with torch semantics.

Counterpart of ``sim2real_lane_segment_tpu.train.schedules``: the closed
form of ``CosineAnnealingLR`` stepped once per epoch, which keeps
oscillating with period 2*T_max past T_max.
"""
from __future__ import annotations

import math


def cosine_annealing(lr0: float, eta_min: float, t_max: int, epoch: int) -> float:
    return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2
