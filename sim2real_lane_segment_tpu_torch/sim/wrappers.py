"""Environment wrappers (reference gym_duckietown/wrappers.py).

Counterpart of the JAX package's ``sim/wrappers.py``: plain wrappers (no
gym needed), each over an env's reset/step, transforming observations or
actions:

- ``DiscreteWrapper``: 3 actions, left / right / forward
  (wrappers.py:7-29).
- ``SteeringToWheelVelWrapper``: (velocity, steering) -> wheel duties
  with gain/trim/k/radius/limit (wrappers.py:32-89).
- ``ResizeWrapper``: resized observations, cv2's INTER_AREA byte for
  byte (``ops.resize.resize_area_u8``), fixing the reference quirk where
  observation() passed frames through unresized (wrappers.py:123-124).
- ``ChannelsFirstWrapper``: HWC uint8 -> CHW float in [0, 1] (the
  PyTorchObsWrapper).
- ``UndistortWrapper``: renders without the fisheye distortion.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_area_u8
from .env import wheel_duty


class _Wrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self):
        return self.observation(self.env.reset())

    def step(self, action):
        obs, r, d, info = self.env.step(self.action(action))
        return self.observation(obs), r, d, info

    def observation(self, obs):
        return obs

    def action(self, a):
        return a


class DiscreteWrapper(_Wrapper):
    LEFT, RIGHT, FORWARD = 0, 1, 2

    def action(self, a):
        if a == self.LEFT:
            return np.array([0.6, 0.0])
        if a == self.RIGHT:
            return np.array([0.0, 0.6])
        if a == self.FORWARD:
            return np.array([0.7, 0.7])
        raise ValueError(f"unknown discrete action {a!r}")


class SteeringToWheelVelWrapper(_Wrapper):
    def __init__(self, env, gain=1.0, trim=0.0, radius=0.0318, k=27.0,
                 limit=1.0):
        super().__init__(env)
        self.params = dict(gain=gain, trim=trim, radius=radius, k=k,
                           limit=limit)

    def action(self, a):
        return wheel_duty(float(a[0]), float(a[1]), **self.params)


class ResizeWrapper(_Wrapper):
    def __init__(self, env, shape=(120, 160)):
        super().__init__(env)
        self.shape = shape

    def observation(self, obs):
        h, w = self.shape
        return resize_area_u8(torch.from_numpy(np.ascontiguousarray(obs)),
                              h, w).numpy()


class ChannelsFirstWrapper(_Wrapper):
    def observation(self, obs):
        return np.transpose(obs, (2, 0, 1)).astype(np.float32) / 255.0


class UndistortWrapper(_Wrapper):
    def __init__(self, env):
        super().__init__(env)
        env.distortion = False
