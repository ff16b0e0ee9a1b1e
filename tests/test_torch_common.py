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


# ---------------------------------------------------------------------------
# augmentation: JAX's draws as the port's AugmentDraws
# ---------------------------------------------------------------------------

def jax_augment_draws(key, n: int, cfg):
    """Replay the key chain of the JAX ``augment_batch`` (``split(key,
    n)``, per sample ``split(k, 5)``, with ``split(k_crop, 3)`` and
    ``split(k_noise, 3)`` beneath it) into the port's ``AugmentDraws``."""
    from sim2real_lane_segment_tpu_torch.ops.augment import (
        MOTION_BLUR_BANK, AugmentDraws)

    def one(k):
        k_hsv, k_crop, k_which, k_mb, k_noise = jax.random.split(k, 5)
        kh, kpos_h, kpos_w = jax.random.split(k_crop, 3)
        _, k_sig, k_g = jax.random.split(k_noise, 3)
        return (jax.random.uniform(k_hsv, (3,), minval=-1.0, maxval=1.0),
                jax.random.randint(kh, (), cfg.min_crop_height,
                                   cfg.max_crop_height + 1),
                jax.random.uniform(kpos_h), jax.random.uniform(kpos_w),
                jax.random.randint(k_mb, (), 0, len(MOTION_BLUR_BANK)),
                jax.random.uniform(k_sig, (), minval=cfg.noise_var_min,
                                   maxval=cfg.noise_var_max),
                jax.random.bernoulli(k_which, 0.5),
                jax.random.normal(k_g, (cfg.height, cfg.width, 3)))

    outs = [np.array(a) for a in jax.vmap(one)(jax.random.split(key, n))]
    hsv, crop_h, hs, ws, idx, sig2, blur, noise = outs
    return AugmentDraws(
        hsv=torch.from_numpy(hsv), crop_h=torch.from_numpy(crop_h).long(),
        h_start=torch.from_numpy(hs), w_start=torch.from_numpy(ws),
        blur_idx=torch.from_numpy(idx).long(), sigma2=torch.from_numpy(sig2),
        use_blur=torch.from_numpy(blur), noise=torch.from_numpy(noise))


# ---------------------------------------------------------------------------
# train-step gates: the port's parameters after an AdamW step against JAX's
# ---------------------------------------------------------------------------

def assert_adam_step_matches(model, mu, params_ref, mu_ref, lr: float, *,
                             g_atol=5e-4, g_rtol=5e-3, p_atol=1e-4,
                             steps: int = 1) -> None:
    """Gradients (read back from Adam's first moment, mu = 0.1 g after one
    step) and parameters against JAX's.  A gradient that is zero in exact
    arithmetic (a bias whose output only feeds BatchNorm) is float noise
    on both sides, and Adam turns it into a step of up to lr of either
    sign: such elements (|g| <= 1e-5) are held to |p - p_ref| <= 2 lr +
    p_atol.  After ``steps`` steps at ``lr``, mu / 0.1 is the moment's
    weighted sum of the steps' gradients, and the noise bound is 2 lr a
    step."""
    named = dict(model.named_parameters())
    mu_t = dict(zip(named, mu))
    want_p = flat_numpy({"params": params_ref})
    want_mu = flat_numpy({"params": mu_ref})
    assert len(want_p) == len(named)
    for path, arr in want_p.items():
        key_t, want = torch_grad_like(path, arr)
        _, g_ref = torch_grad_like(path, want_mu[path] / 0.1)
        g = mu_t[key_t].numpy() / 0.1
        np.testing.assert_allclose(g, g_ref, atol=g_atol, rtol=g_rtol,
                                   err_msg=path)
        p = named[key_t].detach().numpy()
        real = np.abs(g_ref) > 1e-5
        np.testing.assert_allclose(p[real], want[real], atol=p_atol,
                                   err_msg=path)
        assert (np.abs(p - want)[~real] <= 2 * steps * lr + p_atol).all(), \
            path


def assert_batch_stats_match(model, batch_stats_ref, atol=1e-4) -> None:
    sd = model.state_dict()
    flat = flat_numpy({"batch_stats": batch_stats_ref})
    for path, arr in flat.items():
        key_t, _ = torch_grad_like(path, arr)
        np.testing.assert_allclose(sd[key_t].numpy(), arr, atol=atol,
                                   err_msg=path)
