"""The simulator's data-generation path: the tile maps, the ray-cast
renderer of pixel-aligned (normal, annotated) frame pairs, and batched
expert rollouts (``rollout.expert_rollout``), on the device.

Counterpart of the JAX package's ``sim/`` for data generation; the
interactive ``Simulator`` and the gym server are not part of it yet
(``server.py`` holds only the wire framing).
"""
from .maps import Map, builtin_map, load_map
