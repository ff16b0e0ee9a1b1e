"""Inputs made from ``--seed``: weights, frames, labels, augmentation
draws and Dropout2d masks, on the device, in a few large calls.

Every draw comes from a ``torch.Generator`` on the device seeded with a
sub-seed of the run's seed and a tag, so the same seed gives the same
inputs whatever else a run draws. Seeds may exceed 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.fcdensenet import FCDenseNet, dropout_sites


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed from the run's seed and a tag."""
    words = [int(b) for b in tag.encode()]
    ss = np.random.SeedSequence([seed % (1 << 64), *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def weights(cfg: dict, seed: int, device) -> dict:
    """A state dict under the program's names: conv weights and biases
    uniform in +-1/sqrt(fan_in) (PyTorch's default), BatchNorm scales and
    running variances in [0.75, 1.25), shifts and running means in
    [-0.1, 0.1). One uniform draw for all of it."""
    with torch.device("meta"):
        shapes = {k: (v.shape, v.dtype)
                  for k, v in FCDenseNet(cfg).state_dict().items()}
    floats = {k: s for k, (s, dt) in shapes.items() if dt.is_floating_point}
    lo, width = [], []
    for k, shape in floats.items():
        prefix = k.rsplit(".", 1)[0]
        if "BatchNorm" in k:
            centred = k.endswith(("bias", "running_mean"))
            lo.append(-0.1 if centred else 0.75)
            width.append(0.2 if centred else 0.5)
        else:
            w = shapes[f"{prefix}.weight"][0]
            bound = 1.0 / float(np.sqrt(w[1] * int(np.prod(w[2:]))))
            lo.append(-bound)
            width.append(2 * bound)
    counts = torch.tensor([int(np.prod(s)) for s in floats.values()],
                          device=device)
    u = torch.rand(int(counts.sum()), generator=generator(seed, "weights",
                                                           device),
                   device=device)
    u = u * torch.tensor(width, device=device).repeat_interleave(counts) \
        + torch.tensor(lo, device=device).repeat_interleave(counts)
    out, off = {}, 0
    for k, (shape, dt) in shapes.items():
        if k in floats:
            n = int(np.prod(shape))
            out[k] = u[off:off + n].view(shape)
            off += n
        else:  # num_batches_tracked
            out[k] = torch.zeros(shape, dtype=dt, device=device)
    return out


def frames(n: int, h: int, w: int, seed: int, tag: str, device
           ) -> torch.Tensor:
    """uint8 (n, h, w, 3) BGR frames: smooth random fields (an 8x coarser
    grid upsampled bilinearly) plus pixel noise."""
    g = generator(seed, tag, device)
    coarse = torch.rand(n, 3, h // 8 + 1, w // 8 + 1, generator=g,
                        device=device) * 255.0
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                        align_corners=False)
    x = x + torch.randn(n, 3, h, w, generator=g, device=device) * 12.0
    return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def labels(n: int, h: int, w: int, n_cls: int, seed: int, device
           ) -> torch.Tensor:
    """uint8 (n, h, w) class maps: random classes on an 8x coarser grid,
    upsampled by nearest neighbour."""
    g = generator(seed, "labels", device)
    coarse = torch.randint(0, n_cls, (n, 1, h // 8 + 1, w // 8 + 1),
                           generator=g, device=device).to(torch.float32)
    y = torch.nn.functional.interpolate(coarse, size=(h, w), mode="nearest")
    return y[:, 0].to(torch.uint8).contiguous()


def draws(cfg: dict, aug: dict, steps: int, batch: int, seed: int,
          device) -> dict:
    """Augmentation draws for ``steps`` steps of ``batch`` rows, each
    field stacked on a leading step axis."""
    g = generator(seed, "draws", device)
    h, w = cfg["height"], cfg["width"]
    kw = dict(generator=g, device=device)
    shape = (steps, batch)
    lo, hi = aug["noise_var"]
    return {
        "hsv": torch.rand(*shape, 3, **kw) * 2.0 - 1.0,
        "crop_h": torch.randint(h // 2, 4 * h + 1, shape, **kw),
        "h_start": torch.rand(*shape, **kw),
        "w_start": torch.rand(*shape, **kw),
        "blur_idx": torch.randint(0, aug["blur_kernels"], shape, **kw),
        "sigma2": torch.rand(*shape, **kw) * (hi - lo) + lo,
        "use_blur": torch.rand(*shape, **kw) < aug["blur_share"],
        "noise": torch.randn(*shape, h, w, 3, **kw),
    }


def step_draws(pool: dict, k: int) -> dict:
    return {name: t[k] for name, t in pool.items()}


def masks(cfg: dict, steps: int, batch: int, seed: int, device
          ) -> torch.Tensor:
    """Flat Dropout2d masks, one row a step: per site (in site order) a
    [batch, C] block, 0 or 1/(1 - rate), kept with probability 1 - rate."""
    rate = cfg["dropout_rate"]
    n = batch * sum(dropout_sites(cfg))
    u = torch.rand(steps, n, generator=generator(seed, "masks", device),
                   device=device)
    return (u >= rate).to(torch.float32) / (1.0 - rate)
