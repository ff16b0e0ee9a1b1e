"""Dynamic world objects: NPCs (reference gym_duckietown/objects.py).

Counterpart of the JAX package's ``sim/npc.py``:

- ``DuckiebotNPC``: a lane-following robot driven by the same expert
  controller and kinematics as the agent (the reference used a hand-tuned
  PID over its Bezier curves, objects.py:114-265).
- ``DuckiePedestrian``: a duckie that walks back and forth along a
  segment, pausing and turning at the ends (objects.py:268-364).
- ``TrafficLight``: green and red in turn with a fixed period
  (objects.py:367-409).

Each NPC owns a row of the scene's object table; ``step_npcs`` advances
every NPC one tick and returns the updated table.  The NPCs' state lives
on the host, as the env's pose does: the expert and the physics run on
CPU float32 tensors over host lane arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import physics
from .expert import expert_action


@dataclasses.dataclass
class DuckiebotNPC:
    pos: np.ndarray
    angle: float
    velocity: float = 0.35
    obj_index: int = -1

    def step(self, lane_arrays, tile_size: float, dt: float) -> None:
        """One expert-driven physics step; ``lane_arrays`` on the CPU."""
        pos = torch.as_tensor(np.asarray(self.pos, np.float32))
        angle = torch.tensor(self.angle, dtype=torch.float32)
        act = expert_action(lane_arrays, tile_size, pos, angle,
                            velocity=self.velocity)
        duty = physics.wheel_duty_from_action(act[0], act[1])
        st = physics.step_pose(physics.AgentState(pos, angle, duty), duty,
                               dt=dt)
        self.pos = st.pos.numpy()
        self.angle = float(st.angle)


@dataclasses.dataclass
class DuckiePedestrian:
    start: np.ndarray
    end: np.ndarray
    speed: float = 0.1        # m/s
    pause_steps: int = 20
    obj_index: int = -1
    _t: float = 0.0
    _dir: int = 1
    _pause: int = 0

    @property
    def pos(self) -> np.ndarray:
        return self.start + (self.end - self.start) * self._t

    def step(self, dt: float) -> None:
        if self._pause > 0:
            self._pause -= 1
            return
        seg_len = float(np.linalg.norm(self.end - self.start)) or 1e-6
        self._t += self._dir * self.speed * dt / seg_len
        if self._t >= 1.0 or self._t <= 0.0:
            self._t = float(np.clip(self._t, 0.0, 1.0))
            self._dir *= -1
            self._pause = self.pause_steps


@dataclasses.dataclass
class TrafficLight:
    period_steps: int = 100
    obj_index: int = -1
    _count: int = 0

    GREEN = (40, 220, 60)
    RED = (230, 40, 40)

    @property
    def is_green(self) -> bool:
        return (self._count // self.period_steps) % 2 == 0

    @property
    def color(self):
        return self.GREEN if self.is_green else self.RED

    def step(self) -> None:
        self._count += 1


def step_npcs(npcs: list, objects: np.ndarray, lane_arrays, tile_size: float,
              dt: float = 1.0 / 30.0) -> np.ndarray:
    """Advance every NPC one tick; return an updated copy of the (n, 12)
    object table (``render.SceneArrays.objects``'s columns)."""
    objects = np.array(objects)
    for npc in npcs:
        if isinstance(npc, DuckiebotNPC):
            npc.step(lane_arrays, tile_size, dt)
            objects[npc.obj_index, 0:2] = npc.pos
            if objects.shape[1] >= 12:  # keep the OBB footprint's yaw live
                objects[npc.obj_index, 11] = npc.angle
        elif isinstance(npc, DuckiePedestrian):
            npc.step(dt)
            objects[npc.obj_index, 0:2] = npc.pos
        elif isinstance(npc, TrafficLight):
            npc.step()
            objects[npc.obj_index, 4:7] = npc.color
        else:
            raise TypeError(f"unknown npc {type(npc)}")
    return objects
