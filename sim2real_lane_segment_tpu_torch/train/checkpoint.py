"""Checkpoints: bare weights and the train-state manager.

Counterpart of the JAX package's ``train/checkpoint.py``.  Bare weights
(``save_weights``/``load_weights``) are a torch state dict (``.pt``), a
Flax ``.msgpack`` weights file (what Flax's ``serialization.to_bytes``
writes, read by ``read_msgpack`` without Flax or msgpack), or Flax
variables flattened to an ``.npz`` (``np.savez(path, **flatten_dict(
variables, sep="/"))``); the Flax trees go through ``models.flax_import``.
``save_train_state``/``load_train_state`` keep the train state (model,
optimizer, epoch, metrics) for the fit loop's best and latest checkpoints.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch
from torch import nn

from ..models.flax_import import state_dict_from_flax


def save_weights(path: str, model: nn.Module) -> None:
    """The model's state dict, the reference ``best_weights.pt`` analog."""
    atomic_save(model.state_dict(), path)


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Load ``.pt``, ``.msgpack`` or ``.npz`` weights into ``model`` in
    place."""
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            sd = state_dict_from_flax({k: z[k] for k in z.files}, model)
    elif path.endswith(".msgpack"):
        with open(path, "rb") as f:
            flat = flatten(read_msgpack(f.read()))
        try:
            sd = state_dict_from_flax(flat, model)
        except KeyError:
            remapped = remap_legacy_flat(flat, model)
            if remapped is None:
                raise
            sd = state_dict_from_flax(remapped, model)
    else:
        raise ValueError(f"unknown weights format (want .pt, .msgpack or "
                         f".npz): {path}")
    model.load_state_dict(sd)
    return model


# ---------------------------------------------------------------------------
# Flax .msgpack weights
# ---------------------------------------------------------------------------

def read_msgpack(data: bytes):
    """Decode the msgpack subset that Flax's ``serialization.to_bytes``
    writes: maps, arrays, str, bin, nil, bools, ints, floats, and the
    extension types 1 (ndarray) and 3 (numpy scalar), each a packed
    ``(shape, dtype name, buffer)``.  Arrays come back as numpy."""
    value, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return value


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _read(data: bytes, pos: int, fmt: str):
    return struct.unpack_from(fmt, data, pos)[0], pos + struct.calcsize(fmt)


def _unpack(data: bytes, pos: int):
    b = data[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0xa0 <= b <= 0xbf:
        return _take(data, pos, b & 0x1f, str)
    if 0x90 <= b <= 0x9f:
        return _items(data, pos, b & 0x0f)
    if 0x80 <= b <= 0x8f:
        return _pairs(data, pos, b & 0x0f)
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    if b in _FIXED:
        return _read(data, pos, _FIXED[b])
    if b in _STR or b in _BIN:
        n, pos = _read(data, pos, (_STR if b in _STR else _BIN)[b])
        return _take(data, pos, n, str if b in _STR else bytes)
    if b in _ARRAY:
        n, pos = _read(data, pos, _ARRAY[b])
        return _items(data, pos, n)
    if b in _MAP:
        n, pos = _read(data, pos, _MAP[b])
        return _pairs(data, pos, n)
    if b in _EXT or b in _FIXEXT:
        if b in _EXT:
            n, pos = _read(data, pos, _EXT[b])
        else:
            n = _FIXEXT[b]
        code, pos = _read(data, pos, ">b")
        return _ext(code, data[pos:pos + n]), pos + n
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _take(data: bytes, pos: int, n: int, kind):
    raw = data[pos:pos + n]
    return (raw.decode("utf-8") if kind is str else bytes(raw)), pos + n


def _items(data: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos)
        out.append(v)
    return out, pos


def _pairs(data: bytes, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        out[k], pos = _unpack(data, pos)
    return out, pos


def _ext(code: int, payload: bytes):
    if code not in (1, 3):
        raise ValueError(f"msgpack: unsupported extension type {code}")
    shape, dtype, buf = read_msgpack(payload)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return arr if code == 1 else arr[()]


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict -> ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def remap_legacy_flat(flat: dict, model: nn.Module) -> dict | None:
    """Map a pre-split flat module layout onto the featureExtractor/
    classifier split (the JAX ``_remap_legacy_flat``).

    Early LaneNetLite weights (``artifacts/lanenet_lite_sim.msgpack``) were
    saved from a flat module: ``ConvBN_*``, ``ResBlock_*`` and ``head`` at
    the top level of each collection.  Returns the re-nested flat tree, or
    None if the layouts do not correspond."""
    subs = {sub: {name for name, _ in getattr(model, sub).named_children()}
            for sub in ("featureExtractor", "classifier")
            if hasattr(model, sub)}
    if len(subs) != 2 or subs["featureExtractor"] & subs["classifier"]:
        return None
    out = {}
    for path, arr in flat.items():
        coll, top, *rest = path.split("/")
        owner = [sub for sub, names in subs.items() if top in names]
        if not owner or not rest:
            return None
        out["/".join([coll, owner[0], top, *rest])] = arr
    return out


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
