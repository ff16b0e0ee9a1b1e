"""Train a CycleGAN for sim->real domain transfer.

Counterpart of the JAX package's ``cli/train_cyclegan.py``, with its
flags: trains the full unpaired cycle (``train.cyclegan``) on two PNG
directories and saves both generators as state dicts in the reference's
``nn.Sequential`` layout (``g_ab.pt``, ``g_ba.pt``), which
``cli.sim2real_convert`` loads, plus ``history.jsonl``:

    python -m sim2real_lane_segment_tpu_torch.cli.train_cyclegan \\
        --source_dir simData/train/input --target_dir realData/unlabelled \\
        --out results/cyclegan --epochs 60
    python -m sim2real_lane_segment_tpu_torch.cli.sim2real_convert \\
        --dataPath simData --modelWeightsPath results/cyclegan/g_ab.pt

Frames are read as BGR (``data.png``) and brought to ``--height`` x
``--width`` by ``ops.resize.resize_cubic_u8`` (cv2's INTER_CUBIC) on the
card.  Training runs on the card unless ``main`` is given
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os

import numpy as np

from . import common

log = logging.getLogger(__name__)


def load_image_stack(path: str, height: int, width: int, limit: int = 0,
                     device=None) -> np.ndarray:
    """PNGs under ``path`` (or its ``**/input/`` subtrees) -> [-1, 1]
    float32 NHWC in BGR order, resized on ``device`` (default ``cuda``)."""
    import torch

    from ..core.runtime import resolve_device
    from ..data.png import read_png
    from ..ops.resize import resize_cubic_u8

    device = resolve_device(device)
    paths = sorted(glob.glob(os.path.join(path, "*.png")))
    if not paths:
        paths = sorted(glob.glob(os.path.join(path, "**", "input", "*.png"),
                                 recursive=True))
    if limit:
        paths = paths[:limit]
    if not paths:
        raise SystemExit(f"no PNGs under {path}")
    imgs = np.stack([
        resize_cubic_u8(torch.from_numpy(read_png(p)).to(device), height,
                        width).cpu().numpy() for p in paths])
    return (imgs.astype(np.float32) / 255.0 - 0.5) / 0.5


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_dir", required=True, help="domain A PNGs")
    p.add_argument("--target_dir", required=True, help="domain B PNGs")
    p.add_argument("--out", default="results/cyclegan")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("-b", "--batch_size", type=int, default=4)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("-lr", "--learningRate", type=float, default=2e-4)
    p.add_argument("--num_residual_blocks", type=int, default=9)
    p.add_argument("--lambda_cyc", type=float, default=10.0)
    p.add_argument("--lambda_id", type=float, default=5.0)
    p.add_argument("--max_images", type=int, default=0,
                   help="cap images per domain (0 = all)")
    p.add_argument("--seed", type=int, default=42)
    return p


def main(args=None, device=None) -> dict:
    """Train and save; ``device`` defaults to ``cuda`` and raises without
    a card."""
    import torch

    from ..core.runtime import resolve_device
    from ..train.checkpoint import atomic_save
    from ..train.cyclegan import CycleGANTrainer, fit_cyclegan

    common.setup_logging()
    args = build_parser().parse_args(args)
    device = resolve_device(device)
    images_a = load_image_stack(args.source_dir, args.height, args.width,
                                args.max_images, device)
    images_b = load_image_stack(args.target_dir, args.height, args.width,
                                args.max_images, device)
    log.info("domain A: %d images, domain B: %d images (%dx%d)",
             len(images_a), len(images_b), args.height, args.width)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)  # the initial weights
        trainer = CycleGANTrainer(
            num_residual_blocks=args.num_residual_blocks,
            lr=args.learningRate, lambda_cyc=args.lambda_cyc,
            lambda_id=args.lambda_id, device=device)
    history = fit_cyclegan(trainer, images_a, images_b, epochs=args.epochs,
                           batch_size=args.batch_size, seed=args.seed,
                           log_every=5, log=log)

    for name, net in (("g_ab", trainer.g_ab), ("g_ba", trainer.g_ba)):
        atomic_save({k: v.cpu() for k, v in net.state_dict().items()},
                    os.path.join(args.out, f"{name}.pt"))
    with open(os.path.join(args.out, "history.jsonl"), "w") as f:
        for row in history:
            f.write(json.dumps(row) + "\n")
    log.info("saved generators to %s", args.out)
    return {"out": args.out, "final": history[-1]}


if __name__ == "__main__":
    main()
