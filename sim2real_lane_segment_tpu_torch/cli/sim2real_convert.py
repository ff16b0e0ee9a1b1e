"""CycleGAN domain-transfer CLI, the reference ``utils/sim2real_convert.py``.

Counterpart of the JAX package's ``cli/sim2real_convert.py``, with its
flags: ``--dataPath``, ``--modelWeightsPath``, ``--batch_size``,
``--num_residual_blocks`` and ``--overwriteData`` (accepted, unused, as
in the reference).  Restyles every ``**/input/*.png`` under
``--dataPath`` in place: cv2-bicubic down to 160x120
(``ops.resize.resize_cubic_u8``), ``/255``, ``(x - 0.5) / 0.5``, the
generator under ``DEFAULT_POLICY``, ``clip((y + 1) / 2 * 255, 0, 255)``
truncated to uint8 (as JAX's ``astype``), then LANCZOS4 up to 640x480
(``resize_lanczos4_u8``).  BGR order end to end, as the reference.

Weights: a state dict in the reference's layout (``.pt``/``.pth``: what
``cli.train_cyclegan`` writes, or a reference checkpoint), or the JAX
package's Flax ``.msgpack`` (``g_ab.msgpack``).  Runs on the card unless
``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import glob
import logging
import math
import os

import numpy as np
import torch

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from . import common

log = logging.getLogger(__name__)

# the generator's input size (reference sim2real_convert.py) and the
# simulator's frame size it restores
GEN_SIZE = (120, 160)
OUT_SIZE = (480, 640)
_INV_255 = float(np.float32(1) / np.float32(255))


def load_generator(path: str, num_residual_blocks: int = 9,
                   policy: DTypePolicy = DEFAULT_POLICY, device=None):
    """A ``GeneratorResNet`` on ``device`` holding the weights at
    ``path`` (``.pt``/``.pth`` state dict, or Flax ``.msgpack``)."""
    from ..core.runtime import resolve_device
    from ..models.cyclegan import GeneratorResNet
    from ..models.flax_import import cyclegan_state_dict_from_flax
    from ..train.checkpoint import flatten, read_msgpack

    model = GeneratorResNet(num_residual_blocks=num_residual_blocks,
                            policy=policy)
    if path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
    elif path.endswith(".msgpack"):
        with open(path, "rb") as f:
            sd = cyclegan_state_dict_from_flax(
                flatten(read_msgpack(f.read())), model)
    else:
        raise ValueError(f"unknown generator weights format (want .pt, "
                         f".pth or .msgpack): {path}")
    model.load_state_dict(sd)
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def generate(model, batch_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) BGR on the model's device -> the generator's
    uint8 (N, H, W, 3), truncated as JAX's ``astype(uint8)``."""
    from ..ops.resize import device_constant

    dev = batch_u8.device
    # XLA's form of the JAX step's divisions by constants: products with
    # their float32 reciprocals (1/0.5 and 1/2 are exact)
    x = batch_u8.to(torch.float32) * device_constant(_INV_255, dev)
    x = (x - 0.5) * 2.0
    y = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    y = (y + 1.0) * 0.5 * 255.0
    return y.clamp(0, 255).to(torch.uint8)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataPath", type=str, required=True)
    p.add_argument("--overwriteData", action="store_true",
                   help="Currently unused.")
    p.add_argument("--modelWeightsPath", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_residual_blocks", type=int, default=9,
                   help="reference GeneratorResNet used 9 "
                        "(sim2real_convert.py:90)")
    return p


def main(args=None, device=None) -> int:
    """Restyle in place; returns the frame count.  ``device`` defaults to
    ``cuda`` and raises without a card."""
    from ..core.runtime import resolve_device
    from ..data.png import read_png, write_png
    from ..ops.resize import resize_cubic_u8, resize_lanczos4_u8

    common.setup_logging()
    args = build_parser().parse_args(args)
    dev = resolve_device(device)
    model = load_generator(args.modelWeightsPath, args.num_residual_blocks,
                           device=dev)

    imgs = sorted(glob.glob(os.path.join(args.dataPath, "**", "input",
                                         "*.png"), recursive=True))
    print(f"Found images length: {len(imgs)}")
    n_batches = math.ceil(len(imgs) / args.batch_size)
    for b in range(n_batches):
        paths = imgs[b * args.batch_size:(b + 1) * args.batch_size]
        batch = torch.stack([
            resize_cubic_u8(torch.from_numpy(read_png(p)).to(dev), *GEN_SIZE)
            for p in paths])
        out = resize_lanczos4_u8(generate(model, batch), *OUT_SIZE)
        for path, img in zip(paths, out.cpu().numpy()):
            write_png(path, img)
        if (b + 1) % 20 == 0:
            log.info("batch %d/%d", b + 1, n_batches)
    return len(imgs)


if __name__ == "__main__":
    main()
