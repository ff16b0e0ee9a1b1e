"""The simulator: the tile maps, the ray-cast renderer of pixel-aligned
(normal, annotated) frame pairs, batched expert rollouts
(``rollout.expert_rollout``), and the gym-style ``Simulator`` /
``DuckietownEnv`` with NPCs and collisions, its wrappers and the gym
server (``server.py``).

Counterpart of the JAX package's ``sim/``.  Scenes and renders live on
the device; an env's pose, NPCs and reward on the host.
"""
from .maps import Map, builtin_map, load_map
from .env import Simulator, DuckietownEnv
