"""Differential-drive kinematics, batched over agents.

Counterpart of the JAX package's ``sim/physics.py``: the reference
dynamics (simulator.py:1236-1268 update_physics, :1750-1784 _update_pos),
wheel velocities to a body twist to a pose, with the exact rotation about
the instantaneous centre of curvature when the wheels differ; and the
wheel-duty conversion of DuckietownEnv (envs/duckietown_env.py:48-84).
Every function takes tensors with any leading batch shape.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# physical constants (duckiebot)
WHEEL_DIST = 0.102        # m, baseline between wheels
ROBOT_SPEED = 1.20        # max speed scale m/s
CAMERA_HEIGHT = 0.108     # m
CAMERA_FORWARD_DIST = 0.066
CAMERA_ANGLE = 19.15      # degrees downward pitch


def _reciprocal(c: float) -> float:
    """1 / c in float32: the JAX package's jitted rollout divides by its
    constants as XLA folds it, a product with the float32 reciprocal."""
    return float(np.float32(1) / np.float32(c))


class AgentState(NamedTuple):
    pos: torch.Tensor    # (..., 2) world x, z  (y is up; ground plane y=0)
    angle: torch.Tensor  # (...) heading, radians; 0 = +x
    vels: torch.Tensor   # (..., 2) last wheel velocities


def wheel_duty_from_action(velocity, steering, *, gain=1.0, trim=0.0,
                           radius=0.0318, k=27.0, limit=1.0,
                           wheel_dist=WHEEL_DIST) -> torch.Tensor:
    """DuckietownEnv action conversion: (..., 2) duties (left, right)."""
    inv_radius = _reciprocal(radius)
    omega_r = (velocity + 0.5 * steering * wheel_dist) * inv_radius
    omega_l = (velocity - 0.5 * steering * wheel_dist) * inv_radius
    k_r_inv = (gain + trim) / k
    k_l_inv = (gain - trim) / k
    u_r = torch.clamp(omega_r * k_r_inv, -limit, limit)
    u_l = torch.clamp(omega_l * k_l_inv, -limit, limit)
    return torch.stack([u_l, u_r], -1)


def step_pose(state: AgentState, wheel_vels: torch.Tensor, dt: float,
              robot_speed: float = ROBOT_SPEED,
              wheel_dist: float = WHEEL_DIST) -> AgentState:
    """Integrate one physics step (exact ICC arc, simulator.py:1750-1784)."""
    vl = wheel_vels[..., 0] * robot_speed
    vr = wheel_vels[..., 1] * robot_speed
    straight = torch.abs(vl - vr) < 1e-7
    px0, pz0, ang = state.pos[..., 0], state.pos[..., 1], state.angle

    # straight-line branch
    d = 0.5 * (vl + vr) * dt
    pos_s = torch.stack([px0 + d * torch.cos(ang),
                         pz0 + d * (-torch.sin(ang))], -1)

    # arc branch around the ICC, perpendicular-left of the heading at the
    # signed radius r (the z axis points "south")
    w = (vr - vl) * _reciprocal(wheel_dist)
    r = wheel_dist / 2 * (vl + vr) / (vr - vl + 1e-12)
    rot = w * dt
    cx = px0 - r * torch.sin(ang)
    cz = pz0 - r * torch.cos(ang)
    px, pz = px0 - cx, pz0 - cz
    npx = px * torch.cos(rot) + pz * torch.sin(rot)
    npz = -px * torch.sin(rot) + pz * torch.cos(rot)
    pos_a = torch.stack([cx + npx, cz + npz], -1)

    pos = torch.where(straight[..., None], pos_s, pos_a)
    angle = torch.where(straight, ang, ang + rot)
    return AgentState(pos=pos, angle=angle, vels=wheel_vels)


def heading_vec(angle: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(angle), -torch.sin(angle)], -1)
