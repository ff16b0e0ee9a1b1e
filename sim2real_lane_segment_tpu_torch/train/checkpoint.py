"""Checkpoints: bare weights and the train-state manager.

Counterpart of the JAX package's ``train/checkpoint.py``.  Bare weights
(``save_weights``/``load_weights``) are a torch state dict (``.pt``), or
Flax variables flattened to an ``.npz`` and routed through
``models.flax_import``; ``save_train_state``/``load_train_state`` keep the
train state (model, optimizer, epoch, metrics) for the fit loop's best
and latest checkpoints.  The Flax ``.msgpack`` format is not read; a
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
    atomic_save(model.state_dict(), path)


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


def atomic_save(obj, path: str) -> None:
    """``torch.save`` to a temporary file, then rename over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_state(path: str, epoch: int, state: dict, *, metrics: dict,
                     hparams: dict | None = None) -> None:
    """One train checkpoint: ``state`` (``model`` and ``optimizer`` state
    dicts) with its ``epoch``, ``metrics`` and ``hparams``, written
    atomically over ``path``.  The fit loop keeps two, the best by
    ``val_iou`` and the latest epoch (the JAX package's two orbax
    channels)."""
    atomic_save({"epoch": int(epoch),
                 "metrics": {k: float(v) for k, v in metrics.items()},
                 "hparams": hparams or {}, **state}, path)


def load_train_state(path: str) -> dict:
    """A checkpoint written by ``save_train_state``; FileNotFoundError when
    there is none."""
    return torch.load(path, map_location="cpu", weights_only=True)
