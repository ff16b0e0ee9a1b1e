"""Distillation CLI: train the LaneNetLite student from a trained teacher.

Counterpart of the JAX package's ``cli/distill.py``, with its flags:

    python -m sim2real_lane_segment_tpu_torch.cli.distill \\
        --dataPath simData --teacherPath results/baseline/best_weights.pt \\
        --teacher_arch 67 --augment -b 32

The teacher (``--teacher_arch``, weights ``.pt``, ``.msgpack`` or
``.npz``) is loaded through ``cli.test.load_trainer_and_state``; on the
card an FC-DenseNet teacher runs through kernel K4
(``train.distill.DistillTrainer``).  The student trains on ``train`` of
``--dataPath`` (``valid`` and ``test`` score it) with the fit loop of
``cli.train``; artifacts go to ``<default_root_dir or
results>/<model_name>``, and ``best_weights.pt`` serves through
``cli.serve --arch lite``.  ``--device_cache`` keeps the splits on the
device (the steps run one by one: distillation has no multi-step
dispatch).  Runs on the card unless ``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging
import os

from ..core import runtime
from . import common

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from .test import ARCHES

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataPath", type=str, required=True)
    p.add_argument("--teacherPath", type=str, required=True,
                   help="best_weights.pt (.msgpack, .npz) of a trained "
                        "teacher")
    p.add_argument("--teacher_arch", choices=ARCHES, default="67")
    p.add_argument("--model_name", type=str, default="lanenet_lite")
    p.add_argument("--max_epochs", type=int, default=75)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--default_root_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    common.add_data_args(p)
    common.add_model_args(p)
    return p


def main(args=None, device=None) -> dict:
    """Distill; ``device`` defaults to ``cuda`` and raises without a
    card."""
    import torch

    from ..data.modules import SimulatorDataModule
    from ..train.distill import DistillTrainer
    from ..train.loop import fit
    from .test import build_model, load_trainer_and_state

    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()

    teacher = load_trainer_and_state(
        "baseline", args.teacherPath, arch=args.teacher_arch,
        height=args.height, width=args.width, device=device).model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)  # the student's initial weights
        student = build_model("lite", 4)
    trainer = DistillTrainer(
        teacher=teacher, num_cls=4, lr=args.learningRate, decay=args.decay,
        lr_ratio=args.lrRatio, temperature=args.temperature,
        alpha=args.alpha, height=args.height, width=args.width,
        augment=args.augment, student_model=student, device=device)
    data = SimulatorDataModule(args.dataPath, batch_size=args.batch_size,
                               seed=args.seed,
                               load_into_memory=args.load2memory,
                               device_cache=args.device_cache, device=device)
    data.setup()
    out_dir = os.path.join(args.default_root_dir or "results",
                           args.model_name)
    _, best_iou, _ = fit(trainer, data, max_epochs=args.max_epochs,
                         out_dir=out_dir, seed=args.seed)
    log.info("student best val_iou %.4f; artifacts in %s", best_iou, out_dir)
    return {"best_iou": best_iou, "out_dir": out_dir}


if __name__ == "__main__":
    main()
