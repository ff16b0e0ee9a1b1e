"""Round-robin multi-map environment (reference envs/multimap_env.py:
8-99): each reset moves to the next builtin map, for multi-task training.

Counterpart of the JAX package's ``sim/multimap.py``."""
from __future__ import annotations

from .env import DuckietownEnv
from .maps import BUILTIN_MAPS


class MultiMapEnv:
    def __init__(self, **env_kwargs):
        self.env_names = sorted(BUILTIN_MAPS)
        self.envs = [DuckietownEnv(map_name=n, **env_kwargs)
                     for n in self.env_names]
        self.cur_env_idx = 0

    @property
    def env(self):
        return self.envs[self.cur_env_idx]

    def reset(self):
        self.cur_env_idx = (self.cur_env_idx + 1) % len(self.envs)
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def render_obs(self, *a, **kw):
        return self.env.render_obs(*a, **kw)
