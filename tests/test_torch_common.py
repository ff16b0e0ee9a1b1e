"""Shared helpers for the PyTorch port's tests (no tests of its own).

Data crosses between the JAX package and the port as numpy: Flax
variables are flattened to ``/``-joined numpy leaves, the layout the
port's weight bridge (``models/flax_import.py``) reads.
"""
import jax
import numpy as np
import torch
from flax import traverse_util

torch.set_num_threads(2)


def flat_numpy(variables) -> dict:
    """Flax variables -> {"params/.../kernel": np.ndarray, ...}."""
    flat = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
    return {k: np.asarray(v) for k, v in flat.items()}


def unflatten(flat: dict):
    return traverse_util.unflatten_dict(
        {k: jax.numpy.asarray(v) for k, v in flat.items()}, sep="/")


def perturb_bn(flat: dict, seed: int) -> dict:
    """Non-trivial BatchNorm affine and running statistics, from numpy."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        if "BatchNorm" not in k:
            continue
        leaf = k.rsplit("/", 1)[1]
        if leaf == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf == "bias":
            out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif leaf == "mean":
            out[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif leaf == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def jax_variables(module, x_shape, seed: int, **apply_kw) -> dict:
    """Initialized Flax variables with perturbed BatchNorm, flattened."""
    x0 = np.zeros(x_shape, np.float32)
    variables = jax.jit(lambda k, x: module.init(k, x, **apply_kw))(
        jax.random.key(seed), x0)
    return perturb_bn(flat_numpy(variables), seed)


def load_port(module: torch.nn.Module, flat: dict) -> torch.nn.Module:
    from sim2real_lane_segment_tpu_torch.models.flax_import import \
        state_dict_from_flax

    module.load_state_dict(state_dict_from_flax(flat, module))
    return module.eval()


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nchw_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
