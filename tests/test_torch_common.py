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


# ---------------------------------------------------------------------------
# train-path helpers: the JAX kernels' channel-major layout and masks
# ---------------------------------------------------------------------------

def to_cm(x: np.ndarray):
    """NCHW numpy -> the JAX train kernels' [B, C, Ppad] (zero-padded)."""
    from sim2real_lane_segment_tpu.models.tiramisu_train_pallas import _to_cm
    _, _, h, w = x.shape
    return _to_cm(jax.numpy.asarray(np.transpose(x, (0, 2, 3, 1))), h, w)


def from_cm(y, h: int, w: int) -> np.ndarray:
    """[B, C, Ppad] -> NCHW numpy."""
    from sim2real_lane_segment_tpu.models.tiramisu_train_pallas import \
        _from_cm
    return np.transpose(np.asarray(_from_cm(y, h, w)), (0, 3, 1, 2))


def wf_rows(w: np.ndarray) -> np.ndarray:
    """The port's [c, taps, n] weight -> the JAX kn2row [taps*n, c]."""
    c, taps, n = w.shape
    return np.ascontiguousarray(np.transpose(w, (1, 2, 0)).reshape(taps * n,
                                                                   c))


def jax_drop_masks(key, sites, rate: float, batch: int) -> list:
    """The JAX train path's own Dropout2d masks, as [B, C] torch tensors."""
    from sim2real_lane_segment_tpu.models.tiramisu_train_pallas import \
        _drop_mask
    return [torch.from_numpy(np.array(_drop_mask(key, s, rate, batch, c))[
        ..., 0]) for s, c in enumerate(sites)]


def torch_grad_like(flax_path: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """A Flax parameter (or its gradient) -> (state-dict key, torch layout)."""
    from sim2real_lane_segment_tpu_torch.models.flax_import import _torch_key
    key, convert = _torch_key(flax_path)
    return key, (convert(arr) if convert is not None else arr)
