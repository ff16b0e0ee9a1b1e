"""Flax -> torch weight bridge (the inverse of the JAX package's
``models/torch_import.py``).

Input is a Flax variable tree flattened to numpy arrays under ``/``-joined
paths, e.g. ``params/featureExtractor/denseDown0/DenseLayer_0/Conv_0/
kernel`` or ``batch_stats/.../BatchNorm_0/mean`` (what
``flax.traverse_util.flatten_dict(variables, sep="/")`` gives, saved with
``np.savez``).  The port's modules carry the Flax names, so a path maps to
a state-dict key by joining the module path with ``.``: FC-DenseNet's, and
LaneNetLite's (``params/featureExtractor/ResBlock_2/Conv_1/kernel``, a
bias-free 1x1 shortcut, or ``params/classifier/head/kernel`` and
``.../bias``, the 1x1 class head) and EncDecNet's (``params/enc0/Conv_0/
kernel``, ``params/enc0/prelu_alpha``, ``params/classifier/kernel``).

Layouts:
- Conv kernel HWIO -> torch OIHW.
- ConvTranspose kernel HWIO -> torch IOHW, flipped spatially:
  ``lax.conv_transpose(transpose_kernel=False)`` (Flax's default) runs a
  forward correlation over the dilated input, while
  ``F.conv_transpose2d`` scatters with the kernel as given.
- BatchNorm ``scale/bias`` -> ``weight/bias``; ``batch_stats`` ``mean/var``
  -> ``running_mean/running_var``.

The learning demos' policies (``learning/``: PolicyCNN, ActorCNN,
CriticCNN) carry the Flax names too; ``policy_state_dict_from_flax`` maps
their ``Conv_i`` kernels HWIO -> OIHW and their ``Dense_i`` kernels
(in, out) -> (out, in).  The port flattens their last conv's output in
Flax's NHWC order, so ``Dense_0``'s rows need no permutation.

The CycleGAN networks are the exception: the port builds them in the
reference's ``nn.Sequential`` layout, so ``cyclegan_state_dict_from_flax``
maps the Flax convolutions onto the port's in the order they are applied
(``Conv_0..2``, then ``ResidualBlock_j/Conv_0..1``, then the remaining
``Conv_i``).
"""
from __future__ import annotations

import re
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
    if coll == "params" and leaf == "prelu_alpha":  # EncDecNet's PReLU
        return prefix + ".prelu_alpha", None
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


def _flax_conv_order(paths) -> list[str]:
    """Flax conv module paths of a CycleGAN network (``Conv_3``,
    ``ResidualBlock_0/Conv_1`` ...) in the order the network applies
    them: the stem and downsampling ``Conv_0..2``, the residual blocks,
    then the rest."""
    def index(name):
        return int(name.rsplit("_", 1)[1])
    top = sorted((p for p in paths if "/" not in p), key=index)
    blocks = sorted({p.split("/")[0] for p in paths if "/" in p}, key=index)
    inner = [f"{b}/Conv_{k}" for b in blocks for k in (0, 1)]
    return top[:3] + inner + top[3:]


def cyclegan_state_dict_from_flax(flat: Mapping[str, np.ndarray],
                                  model: nn.Module
                                  ) -> dict[str, torch.Tensor]:
    """Flax ``GeneratorResNet`` or ``Discriminator`` variables, flattened
    to ``params/<module path>/kernel|bias`` numpy leaves (the ``params/``
    prefix is optional), mapped onto the port's ``model`` of the same
    configuration."""
    from .cyclegan import convs

    leaves: dict[str, dict[str, np.ndarray]] = {}
    for path, arr in flat.items():
        path = path.removeprefix("params/")
        m = re.fullmatch(r"(.+)/(kernel|bias)", path)
        if m is None:
            raise KeyError(f"not a CycleGAN conv leaf: {path!r}")
        leaves.setdefault(m.group(1), {})[m.group(2)] = np.asarray(arr)
    order = _flax_conv_order(list(leaves))
    targets = convs(model)
    if len(order) != len(targets):
        raise ValueError(f"{len(order)} Flax convs for {len(targets)} "
                         f"convs in the model")
    names = {id(mod): name for name, mod in model.named_modules()}
    sd = model.state_dict()
    out = {}
    for path, conv in zip(order, targets):
        name = names[id(conv)]
        for leaf, key, convert in (("kernel", "weight", conv_weight),
                                   ("bias", "bias", None)):
            arr = leaves[path][leaf]
            arr = convert(arr) if convert is not None else arr
            want = sd[f"{name}.{key}"]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"{path}/{leaf}: shape {arr.shape} does "
                                 f"not match {name}.{key} "
                                 f"{tuple(want.shape)}")
            out[f"{name}.{key}"] = torch.from_numpy(np.array(arr)).to(
                want.dtype)
    return out


def policy_state_dict_from_flax(flat: Mapping[str, np.ndarray],
                                model: nn.Module
                                ) -> dict[str, torch.Tensor]:
    """A Flax policy's params (``Conv_i/kernel``, ``Dense_i/bias`` ...,
    with or without the ``params/`` prefix: the JAX CLIs save the params
    tree alone) mapped onto the port's ``learning`` module of the same
    configuration, every entry covered, shapes checked."""
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        mod, leaf = path.removeprefix("params/").rsplit("/", 1)
        arr = np.asarray(arr)
        if leaf == "kernel":
            arr = conv_weight(arr) if arr.ndim == 4 else arr.T
        elif leaf != "bias":
            raise KeyError(f"unmapped Flax leaf: {path!r}")
        name = "weight" if leaf == "kernel" else "bias"
        key = f"{mod.replace('/', '.')}.{name}"
        if key not in target:
            raise KeyError(f"{path!r} -> {key!r}: no such entry in the model")
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"{path!r}: shape {arr.shape} does not match "
                             f"{key!r} {tuple(target[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr)).to(target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"Flax variables do not cover {missing}")
    return out
