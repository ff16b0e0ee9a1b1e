"""Flax -> torch weight bridge (the inverse of the JAX package's
``models/torch_import.py``).

Input is a Flax variable tree flattened to numpy arrays under ``/``-joined
paths, e.g. ``params/featureExtractor/denseDown0/DenseLayer_0/Conv_0/
kernel`` or ``batch_stats/.../BatchNorm_0/mean`` (what
``flax.traverse_util.flatten_dict(variables, sep="/")`` gives, saved with
``np.savez``).  The port's modules carry the Flax names, so a path maps to
a state-dict key by joining the module path with ``.``.

Layouts:
- Conv kernel HWIO -> torch OIHW.
- ConvTranspose kernel HWIO -> torch IOHW, flipped spatially:
  ``lax.conv_transpose(transpose_kernel=False)`` (Flax's default) runs a
  forward correlation over the dilated input, while
  ``F.conv_transpose2d`` scatters with the kernel as given.
- BatchNorm ``scale/bias`` -> ``weight/bias``; ``batch_stats`` ``mean/var``
  -> ``running_mean/running_var``.
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn


def conv_weight(k: np.ndarray) -> np.ndarray:
    """Flax conv HWIO -> torch OIHW."""
    return np.transpose(k, (3, 2, 0, 1))


def conv_transpose_weight(k: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose HWIO -> torch ConvTranspose2d IOHW (flipped)."""
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def _torch_key(path: str) -> tuple[str, Callable | None]:
    """Flax path -> (state-dict key, layout conversion or None)."""
    coll, *mods, leaf = path.split("/")
    if coll not in ("params", "batch_stats") or not mods:
        raise KeyError(f"not a Flax params/batch_stats path: {path!r}")
    prefix = ".".join(mods)
    if coll == "params" and leaf == "kernel":
        fn = (conv_transpose_weight if mods[-1].startswith("ConvTranspose")
              else conv_weight)
        return prefix + ".weight", fn
    if coll == "params" and leaf == "bias":
        return prefix + ".bias", None
    if (coll, leaf) in _BN_LEAVES:
        return f"{prefix}.{_BN_LEAVES[(coll, leaf)]}", None
    raise KeyError(f"unmapped Flax leaf: {path!r}")


def state_dict_from_flax(flat: Mapping[str, np.ndarray],
                         model: nn.Module) -> dict[str, torch.Tensor]:
    """Map flattened Flax variables onto ``model``'s state dict.

    Every Flax leaf must land on a state-dict entry of the same shape, and
    every parameter and running statistic of ``model`` must be covered;
    ``num_batches_tracked`` counters keep the model's values.
    """
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        key, convert = _torch_key(path)
        if key not in target:
            raise KeyError(f"{path!r} -> {key!r}: no such entry in the model")
        arr = np.asarray(arr)
        if convert is not None:
            arr = convert(arr)
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"{path!r}: shape {arr.shape} does not match "
                             f"{key!r} {tuple(target[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr)).to(  # a writable copy
            target[key].dtype)
    missing = [k for k in target
               if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"Flax variables do not cover {missing[:5]} "
                       f"({len(missing)} entries)")
    for k in target:
        out.setdefault(k, target[k])
    return out
