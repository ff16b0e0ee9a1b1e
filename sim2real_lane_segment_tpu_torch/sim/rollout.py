"""Batched expert rollouts with paired rendering, on the device.

Counterpart of the JAX package's ``sim/rollout.py``, the replacement for
interactive recording (manual_control.py) at data-generation scale: one
call drives B agents T steps with the lane-following expert and renders
pixel-aligned (orig, annot) frame pairs of every step.

No rendered pixel feeds back into the physics or the expert, so the
rollout steps all T x B poses first and then renders them in batches of
``RENDER_PIXELS`` pixels (the JAX package renders inside its scan; the
frames are the same).  DR parameters (one row per agent, for the whole
call) and the camera noise (one draw per frame, shared by its pair) come
from a ``torch.Generator`` on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lanes, physics
from .expert import expert_action
from .render import DRParams, SceneArrays, render_pair

# pixels rendered in one batch: ~8.4 M, 27 frames at 480x640
RENDER_PIXELS = 1 << 23


class RolloutBatch(NamedTuple):
    orig: torch.Tensor    # (T, B, H, W, 3) uint8 RGB
    annot: torch.Tensor   # (T, B, H, W, 3) uint8 RGB
    pos: torch.Tensor     # (T, B, 2)
    angle: torch.Tensor   # (T, B)


def step_poses(lane_arrays, tile_size: float, pos: torch.Tensor,
               angle: torch.Tensor, n_steps: int, frame_skip: int = 1):
    """The expert's poses after each of ``n_steps`` steps: ((T, B, 2),
    (T, B)) from ``pos`` (B, 2), ``angle`` (B,)."""
    poses, angles = [], []
    for _ in range(n_steps):
        act = expert_action(lane_arrays, tile_size, pos, angle)
        duty = physics.wheel_duty_from_action(act[..., 0], act[..., 1])
        st = physics.AgentState(pos=pos, angle=angle, vels=duty)
        for _ in range(frame_skip):
            st = physics.step_pose(st, duty, dt=1.0 / 30.0)
        pos, angle = st.pos, st.angle
        poses.append(pos)
        angles.append(angle)
    return torch.stack(poses), torch.stack(angles)


def expert_rollout(scene: SceneArrays, lane_arrays,
                   generator: torch.Generator, init_pos: torch.Tensor,
                   init_angle: torch.Tensor, *, tile_size: float,
                   n_steps: int = 64, height: int = 480, width: int = 640,
                   frame_skip: int = 1, distortion: bool = False,
                   domain_rand: bool = True,
                   procedural: bool = True) -> RolloutBatch:
    """An expert-driven rollout of a batch of agents: init_pos (B, 2),
    init_angle (B,) (spawn them with ``sample_spawns``), on the scene's
    device."""
    B = init_pos.shape[0]
    dev = scene.device
    dr = (DRParams.sample(generator, B) if domain_rand
          else DRParams.default(B, dev))
    pos, angle = step_poses(lane_arrays, tile_size, init_pos.to(dev),
                            init_angle.to(dev), n_steps, frame_skip)
    n = n_steps * B
    per = max(1, RENDER_PIXELS // (height * width))
    orig = torch.empty((n, height, width, 3), dtype=torch.uint8, device=dev)
    annot = torch.empty_like(orig)
    flat_pos, flat_angle = pos.reshape(n, 2), angle.reshape(n)
    agent = torch.arange(n, device=dev) % B
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        noise = torch.randn((hi - lo, height, width, 3), generator=generator,
                            device=dev)
        orig[lo:hi], annot[lo:hi] = render_pair(
            scene, flat_pos[lo:hi], flat_angle[lo:hi],
            dr.index(agent[lo:hi]), noise, height=height, width=width,
            distortion=distortion, procedural=procedural)
    shape = (n_steps, B, height, width, 3)
    return RolloutBatch(orig=orig.reshape(shape), annot=annot.reshape(shape),
                        pos=pos, angle=angle)


def sample_spawns(m, lane_arrays, rng: np.random.Generator, batch: int,
                  device=None):
    """Host-side spawn sampling near a lane centre, lane-aligned, with the
    JAX package's numpy draws: ((batch, 2), (batch,)) float32 on
    ``device``.

    Lanes are two-way (reference tiles carry curves for both directions,
    simulator.py:860-875), so a random heading picks which direction's
    lane the spawn snaps to."""
    la = tuple(a.cpu() for a in lane_arrays)
    drivable = m.drivable_tiles()
    poss, angles = [], []
    while len(poss) < batch:
        i, j = drivable[rng.integers(len(drivable))]
        ts = m.tile_size
        pos = np.array([(i + rng.uniform(0.15, 0.85)) * ts,
                        (j + rng.uniform(0.15, 0.85)) * ts], np.float32)
        probe = rng.uniform(0.0, 2 * np.pi)
        lp = lanes.lane_pos(la, ts, torch.from_numpy(pos),
                            torch.tensor(probe, dtype=torch.float32))
        if not bool(lp.in_lane) or abs(float(lp.dist)) > 0.15:
            continue
        t = lp.tangent.numpy()
        angle = float(np.arctan2(-t[1], t[0])) + rng.uniform(-0.15, 0.15)
        poss.append(pos)
        angles.append(angle)
    return (torch.as_tensor(np.stack(poss), device=device),
            torch.as_tensor(np.asarray(angles, np.float32), device=device))
