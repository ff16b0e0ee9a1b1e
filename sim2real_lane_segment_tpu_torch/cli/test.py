"""Evaluation CLI, the reference ``test.py`` interface, and the model
construction and weight loading of the evaluation and serving CLIs.

Counterpart of the JAX package's ``cli/test.py``:

    python -m sim2real_lane_segment_tpu_torch.cli.test -t mme \\
        --checkpointPath best_weights.pt --testDataPath simRealData/target/test

``main`` writes the sample montage when given ``--trainDataPath`` and
``--realDataPath`` (``results/samplePredictions.png``: per row a train
frame, its prediction overlaid, a real frame, its prediction overlaid;
``--showCount`` rows of frames drawn by ``random.sample`` after
``random.seed(42)``, resized with cv2's LANCZOS4 through
``ops.resize.resize_lanczos4_u8``), then evaluates ``--testDataPath``
(an ``input/`` + ``label/`` PNG directory) in batches: the eval step's
accuracy, Dice and IoU, and the 4x4 confusion matrix of the predictions
(through the fused forward with ``--fused``), printed and returned as the
JAX CLI prints and returns them.  It runs on the card unless given
``device="cpu"``.  Every arch of the JAX CLI is built: the FC-DenseNets
(67, ``67r`` = 67 with its dense blocks recomputed in training, 57, 103,
tiny), LaneNetLite (``lite``) and the legacy EncDecNet (``encdec``).
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import random

import numpy as np

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..core import runtime
from . import common

log = logging.getLogger(__name__)

# the montage's class colours as BGR triples (the JAX CLI's): right lane
# green, left lane blue, obstacle red
OVERLAY_BGR = {1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255)}

ARCHES = ["67", "67r", "57", "103", "tiny", "lite", "encdec"]


def build_model(arch: str, num_cls: int,
                policy: DTypePolicy = DEFAULT_POLICY):
    from ..models.encdec import EncDecNet
    from ..models.lanenet_lite import LaneNetLite
    from ..models.tiramisu import (FCDenseNet, fcdensenet57, fcdensenet67,
                                   fcdensenet103)
    return {"67": lambda: fcdensenet67(num_cls, policy),
            "67r": lambda: fcdensenet67(num_cls, policy, remat=True),
            "57": lambda: fcdensenet57(num_cls, policy=policy),
            "103": lambda: fcdensenet103(num_cls, policy),
            "lite": lambda: LaneNetLite(n_classes=num_cls, policy=policy),
            "encdec": lambda: EncDecNet(n_features=64, n_levels=3,
                                        kernel_size=3, n_classes=num_cls,
                                        policy=policy),
            "tiny": lambda: FCDenseNet(
                n_classes=num_cls, down_blocks=(2, 2), up_blocks=(2, 2),
                bottleneck_layers=2, growth_rate=4,
                out_chans_first_conv=8, policy=policy)}[arch]()


def load_trainer_and_state(module_type: str, checkpoint_path: str,
                           num_cls: int = 4, arch: str = "67",
                           height: int = 120, width: int = 160,
                           device=None, policy: DTypePolicy = DEFAULT_POLICY):
    """A trainer on ``device`` (default ``cuda``) holding the weights at
    ``checkpoint_path`` (``.pt``, ``.msgpack`` or ``.npz``): an
    ``MMETrainer`` for ``mme``, else a ``SupervisedTrainer``.  The model
    holds the weights, so the trainer is the whole state."""
    from ..train.checkpoint import load_weights
    from ..train.mme import MMETrainer
    from ..train.supervised import SupervisedTrainer

    if module_type == "mme":
        trainer_cls = MMETrainer
    elif module_type in ("baseline", "sandt", "hm", "CycleGAN"):
        trainer_cls = SupervisedTrainer
    else:
        raise RuntimeError(f"Cannot recognize module type {module_type}")
    model = build_model(arch, num_cls, policy)
    load_weights(checkpoint_path, model)
    return trainer_cls(num_cls=num_cls, model=model, height=height,
                       width=width, device=device)


def overlay_prediction(img_bgr: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """``img_bgr`` with every pixel of a class painted in its colour."""
    out = img_bgr.copy()
    for cls, color in OVERLAY_BGR.items():
        out[pred == cls] = color
    return out


def sample_montage(trainer, train_paths, real_paths, out_path,
                   predict=None) -> str:
    """One row per (train, real) PNG pair: each frame resized to the
    model's size with cv2's LANCZOS4 and beside it its prediction
    overlaid; written as a PNG to ``out_path``.  ``predict`` (uint8 NHW3
    frames -> class maps) defaults to ``trainer.predict_step``."""
    import torch

    from ..data.png import read_png, write_png
    from ..ops.resize import resize_lanczos4_u8

    predict = predict or trainer.predict_step
    h, w = trainer.cfg.height, trainer.cfg.width
    rows = []
    for tp, rp in zip(train_paths, real_paths):
        imgs = torch.stack([resize_lanczos4_u8(
            torch.from_numpy(read_png(p)).to(trainer.device), h, w)
            for p in (tp, rp)])
        preds = predict(imgs).cpu().numpy()
        imgs = imgs.cpu().numpy()
        rows.append(np.concatenate(
            [imgs[0], overlay_prediction(imgs[0], preds[0]),
             imgs[1], overlay_prediction(imgs[1], preds[1])], axis=1))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, np.concatenate(rows, axis=0))
    return out_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--module_type", required=True,
                   choices=["baseline", "sandt", "hm", "CycleGAN", "mme"])
    p.add_argument("--checkpointPath", type=str, required=True)
    p.add_argument("-c", "--showCount", type=int, default=5)
    p.add_argument("--realDataPath", type=str)
    p.add_argument("--trainDataPath", type=str)
    p.add_argument("--testDataPath", type=str)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--arch", choices=ARCHES, default="67")
    p.add_argument("--fused", action="store_true",
                   help="predict through the fused FC-DenseNet forward")
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    return p


def main(args=None, device=None) -> dict:
    """Evaluate; ``device`` defaults to ``cuda`` and raises without a
    card."""
    import torch

    from ..data.datasets import RightLaneDataset
    from ..data.samplers import batched
    from ..ops.augment import eval_batch
    from ..ops.metrics import confusion_matrix, summarize_weighted

    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    random.seed(42)
    trainer = load_trainer_and_state(
        args.module_type, args.checkpointPath, arch=args.arch,
        height=args.height, width=args.width, device=device)
    predict = (trainer.predict_step_fused if args.fused
               else trainer.predict_step)
    results: dict = {}
    if args.trainDataPath and args.realDataPath:
        train_paths = random.sample(
            glob.glob(os.path.join(args.trainDataPath, "*.png")),
            args.showCount)
        real_paths = random.sample(
            glob.glob(os.path.join(args.realDataPath, "*.png")),
            args.showCount)
        out = sample_montage(trainer, train_paths, real_paths,
                             "results/samplePredictions.png",
                             predict=predict)
        log.info("wrote %s", out)
        results["montage"] = out

    if args.testDataPath:
        ds = RightLaneDataset(args.testDataPath, True)
        outs = []
        conf = torch.zeros(4, 4, dtype=torch.int64, device=trainer.device)
        for idx in batched(np.arange(len(ds)), args.batch_size,
                           drop_last=False):
            images, labels = ds.read_batch(idx)
            outs.append({k: float(v) for k, v in
                         trainer.eval_step(images, labels).items()})
            preds = predict(images)
            _, y = eval_batch(torch.from_numpy(images),
                              torch.from_numpy(labels), trainer.cfg)
            conf += confusion_matrix(preds, y.to(trainer.device), 4)
        logs = summarize_weighted(outs)
        conf = conf.cpu().numpy()
        print(f"Accuracy on test set: {logs['acc']:.4f}%")
        print(f"Dice score on test set: {logs['dice']:.4f}")
        print(f"IoU on test set: {logs['iou']:.4f}")
        print("Confusion matrix (column: prediction, row: label):")
        print(conf)
        print(f"Total: {conf.sum()}")
        results.update(logs)
        results["confusion"] = conf
    return results


if __name__ == "__main__":
    main()
