"""JSON-config-driven domain randomization (reference
gym_duckietown/randomization/ parity), drawn from a ``torch.Generator``.

Counterpart of the JAX package's ``sim/randomization.py``.  The
reference's ``Randomizer`` drew int/uniform/normal samples per config key
each episode (randomizer.py:22-72, config/default_dr.json keys:
horz_mode, light_pos, camera_noise, frame_skip).  Here the same config
schema draws a batch of samples, one per agent, from a generator on the
device.  Consumed by ``render.DRParams.sample`` / ``from_draws``
(light_pos -> positional lighting, horz_mode -> sky colourway,
frame_skip -> physics substeps).

Config entry schema (the reference JSONs'; an "int" high is EXCLUSIVE,
numpy randint semantics like the reference):
  {"<name>": {"type": "int"|"uniform"|"normal", "low": .., "high": ..,
              "loc": .., "scale": .., "size": N}}
"""
from __future__ import annotations

import json
from typing import Any

import torch

DEFAULT_DR_CONFIG: dict[str, Any] = {
    "horz_mode": {"type": "int", "low": 0, "high": 4},
    "light_pos": {"type": "uniform", "low": [-150, 170, -150],
                  "high": [150, 220, 150], "size": 3},
    "light_scale": {"type": "uniform", "low": 0.75, "high": 1.15, "size": 3},
    "camera_noise": {"type": "uniform", "low": 0.0, "high": 4.0},
    "horizon_shift": {"type": "uniform", "low": -25.0, "high": 25.0},
    "frame_skip": {"type": "int", "low": 1, "high": 2},
}

DEFAULT_CONFIG: dict[str, Any] = {
    "horz_mode": {"type": "int", "low": 0, "high": 1},
    "light_pos": {"type": "uniform", "low": [-40, 200, 100],
                  "high": [-40, 200, 100], "size": 3},
    "light_scale": {"type": "uniform", "low": 1.0, "high": 1.0, "size": 3},
    "camera_noise": {"type": "uniform", "low": 0.0, "high": 0.0},
    "horizon_shift": {"type": "uniform", "low": 0.0, "high": 0.0},
    "frame_skip": {"type": "int", "low": 1, "high": 1},
}


class Randomizer:
    def __init__(self, randomization_config_fp: str | None = None,
                 default_config_fp: str | None = None):
        if randomization_config_fp is not None:
            with open(randomization_config_fp) as f:
                self.randomization_config = json.load(f)
        else:
            self.randomization_config = dict(DEFAULT_DR_CONFIG)
        if default_config_fp is not None:
            with open(default_config_fp) as f:
                self.default_config = json.load(f)
        else:
            self.default_config = dict(DEFAULT_CONFIG)

    def randomize(self, generator: torch.Generator,
                  batch: int) -> dict[str, torch.Tensor]:
        """Draw ``batch`` samples of every config key (sorted by name),
        each (batch,) or (batch, size), on the generator's device."""
        return {name: _draw(generator, spec, batch)
                for name, spec in sorted(self.randomization_config.items())}

    def defaults(self, batch: int = 1,
                 device=None) -> dict[str, torch.Tensor]:
        g = torch.Generator(device=device or "cpu").manual_seed(0)
        return {name: _draw(g, spec, batch)
                for name, spec in sorted(self.default_config.items())}


def _draw(generator: torch.Generator, spec: dict[str, Any],
          batch: int) -> torch.Tensor:
    kind = spec.get("type", "uniform")
    size = spec.get("size", 1)
    shape = (batch, size) if size > 1 else (batch,)
    dev = generator.device
    if kind == "int":
        # exclusive high, matching the reference's np.random.randint
        # (randomizer.py:41): its default_dr frame_skip (1, 2) therefore
        # ALWAYS draws 1 (QUIRKS.md)
        low, high = int(spec["low"]), int(spec["high"])
        if high <= low:   # an empty range draws its low, as JAX's randint
            return torch.full(shape, low, dtype=torch.int64, device=dev)
        return torch.randint(low, high, shape, generator=generator,
                             device=dev)
    if kind == "uniform":
        low = torch.as_tensor(spec["low"], dtype=torch.float32, device=dev)
        high = torch.as_tensor(spec["high"], dtype=torch.float32, device=dev)
        u = torch.rand(shape, generator=generator, device=dev)
        return low + (high - low) * u
    if kind == "normal":
        return spec.get("loc", 0.0) + spec.get("scale", 1.0) * torch.randn(
            shape, generator=generator, device=dev)
    raise ValueError(f"unknown randomization type {kind!r}")
