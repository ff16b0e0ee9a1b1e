"""Bare weights: a torch state dict (``.pt``), or Flax variables
flattened to an ``.npz`` and routed through ``models.flax_import``.

Counterpart of ``save_weights``/``load_weights`` in the JAX package's
``train/checkpoint.py``.  The Flax ``.msgpack`` format is not read; a
Flax tree reaches the port as ``np.savez(path, **flatten_dict(variables,
sep="/"))``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..models.flax_import import state_dict_from_flax


def save_weights(path: str, model: nn.Module) -> None:
    """The model's state dict, the reference ``best_weights.pt`` analog."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(model.state_dict(), path)


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Load ``.pt`` or ``.npz`` weights into ``model`` in place."""
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            sd = state_dict_from_flax({k: z[k] for k in z.files}, model)
    else:
        raise ValueError(f"unknown weights format (want .pt or .npz): {path}")
    model.load_state_dict(sd)
    return model
