"""Lane-following expert controller, batched over agents.

Counterpart of the JAX package's ``sim/expert.py``: it plays the role of
the reference's PurePursuitExpert (learning/utils/teacher.py:11-46) and of
the person at the wheel in manual_control.py, a P-controller on (lane distance,
heading error) with curvature feed-forward.
"""
from __future__ import annotations

import torch

from . import lanes


def expert_action(lane_arrays, tile_size, pos, angle, *,
                  velocity: float = 0.5, k_dist: float = 8.0,
                  k_head: float = 4.0, k_slow: float = 0.12) -> torch.Tensor:
    """(..., 2) (velocity, steering) from the lane position.

    Through the duty conversion and the kinematics (physics.py),
    commanded (velocity, steering) yield v and omega scaled by the same
    constant, so tracking an arc of curvature kappa needs exactly
    steering = velocity * kappa.  Tight turns slow down as a person would.
    """
    lp = lanes.lane_pos(lane_arrays, tile_size, pos, angle)
    hx, hz = torch.cos(angle), -torch.sin(angle)
    # signed heading error: negative when the heading points left of the
    # lane tangent (world x east, z south)
    cross = lp.tangent[..., 0] * hz - lp.tangent[..., 1] * hx
    vel = velocity / (1.0 + k_slow * torch.abs(lp.curvature))
    # dist > 0 = right of the lane centre -> steer left (steering > 0)
    steering = k_dist * lp.dist + k_head * cross + vel * lp.curvature
    vel = torch.where(lp.in_lane, vel, torch.full_like(vel, 0.1))
    return torch.stack([vel, torch.clamp(steering, -4.0, 4.0)], -1)
