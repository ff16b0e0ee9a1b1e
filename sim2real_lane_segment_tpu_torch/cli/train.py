"""Training CLI, the reference ``train.py`` interface.

Counterpart of the JAX package's ``cli/train.py``:

    python -m sim2real_lane_segment_tpu_torch.cli.train --trainType sim \\
        --dataPath simData --arch 67 --pallas_train --augment -b 32
    python -m sim2real_lane_segment_tpu_torch.cli.train --trainType mme \\
        --dataPath simRealData --pretrained_path best_weights.pt \\
        --pallas_train --augment -b 32

``--trainType sim`` trains on ``train``/``valid``/``test`` under
``--dataPath``; ``st`` on ``source/`` and ``target/{train,test}`` drawn
50/50 per sample; ``mme`` adds ``target/unlabelled`` and runs MME's
two-phase step from the ``--pretrained_path`` weights (``.pt``,
``.msgpack`` or ``.npz``), which it requires.  ``--augment`` runs the
training augmentation on the card.  ``--pallas_train`` runs the
FC-DenseNet train step through the fused consumer kernels
(``models.tiramisu_train_fused``); ``--fast_train`` (which
``--pallas_train`` overrides) runs it segment-wise
(``models.tiramisu_fast``); without either the plain module trains with
autograd, as ``--arch lite`` (LaneNetLite) and ``encdec`` always do.
``--arch 67r`` is FCDenseNet67 with every dense block recomputed in the
backward of the plain train step (``torch.utils.checkpoint``).  ``--device_cache`` keeps every split on the device
(``data.device_cache``): batches are gathered there, and the fit loop
runs each epoch in chunks of 32 steps (``run_scan_chunk``), every step on
a card one replay of the whole step captured as a CUDA graph, with the
same batches, draws and logged values as without the flag.  A split that
does not fit on the device, or a step that cannot be captured, raises;
nothing falls back to host reads or eager steps.  ``--profile`` writes a
``torch.profiler`` trace of the run to ``<out_dir>/profile/trace.json``
and logs the graph's captures and replays beside the K3a launches and
the captured step's K1-K3b launches, all and at small planes.
Training runs on the card unless ``main`` is given ``device="cpu"``.
Artifacts go to ``<default_root_dir or results>/<model_name>``:
``metrics.jsonl``, ``checkpoints/best.pt`` (best val_iou),
``checkpoints_latest/latest.pt`` and ``best_weights.pt``.

``--dp auto`` (or ``--dp N``, N the number of ranks) trains
data-parallel over ``torch.distributed``, one process per device
(``parallel.dp``): every rank reads its shard of the samplers at the
per-process ``--batch_size`` and steps as one process would on the
global batch; rank 0 logs and checkpoints under ``<out_dir>``, rank r
under ``<out_dir>/proc<r>``.  Launch it with ``torchrun`` (NCCL on
cards, gloo on the CPU):

    torchrun --nproc_per_node 4 -m sim2real_lane_segment_tpu_torch.cli.train \
        --trainType sim --dataPath simData --dp auto --pallas_train -b 32

Without a launcher ``--dp auto`` is a world of one rank, which runs the
same code, collectives included, and the same values as ``--dp off``.
"""
from __future__ import annotations

import argparse
import logging
import os

from ..core import runtime
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trainType", choices=["sim", "st", "mme"], required=True,
                   help="Type of training method")
    p.add_argument("--dataPath", type=str, required=True,
                   help="Path of database root")
    p.add_argument("--pretrained_path", type=str,
                   help="MME training uses pretrained weights")
    p.add_argument("--model_name", type=str, default="baseline",
                   help="Model identifier for logging and checkpoints.")
    p.add_argument("--reproducible", action="store_true",
                   help="Seed everything to 42 for a deterministic run.")
    p.add_argument("--comet", action="store_true",
                   help="Accepted for interface parity; logs locally.")
    p.add_argument("--wandb", action="store_true",
                   help="Accepted for interface parity; logs locally.")
    p.add_argument("--max_epochs", type=int, default=175)
    p.add_argument("--default_root_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--arch", default="67",
                   choices=["67", "67r", "57", "103", "tiny", "lite",
                            "encdec"],
                   help="FCDenseNet variant ('tiny' is a smoke-test config)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the run's checkpoint dirs if present")
    p.add_argument("--log_every", type=int, default=50,
                   help="Log train scalars every N global steps")
    p.add_argument("--fast_train", action="store_true",
                   help="segment-wise FC-DenseNet train forward (no dense "
                        "concats; models/tiramisu_fast.py)")
    p.add_argument("--pallas_train", action="store_true",
                   help="train FC-DenseNets through the fused consumer "
                        "kernels (K1, K2, K3a, K3b)")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the run under "
                        "<out_dir>/profile")
    p.add_argument("--dp", default="off",
                   help="data parallelism over torch.distributed: 'off' "
                        "(default), 'auto' (the launch's ranks, or a world "
                        "of one), or the number of ranks; --batch_size is "
                        "per process")
    common.add_data_args(p)
    common.add_model_args(p)
    return p


def main(args=None, device=None) -> dict:
    """Train; ``device`` defaults to ``cuda`` and raises without a card."""
    import torch

    from ..data.modules import (SimulatorDataModule, TwoDomainDataModule,
                                TwoDomainMMEDataModule)
    from ..parallel import multihost
    from ..parallel.dp import resolve_dp
    from ..train.loop import fit
    from ..train.mme import MMETrainer
    from ..train.supervised import SupervisedTrainer
    from .test import build_model

    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    if args.trainType == "mme" and not args.pretrained_path:
        raise SystemExit("--trainType=mme requires --pretrained_path")
    seed = 42 if args.reproducible else args.seed
    out_dir = os.path.join(args.default_root_dir or "results",
                           args.model_name)
    world, owned = None, False
    if resolve_dp(args.dp, multihost.process_index()[1]):
        world, owned = multihost.init_world(device)
        device = world.device
        if world.rank > 0:
            # the state is replicated, so rank 0's artifacts are the run's;
            # the others write beside them
            out_dir = os.path.join(out_dir, f"proc{world.rank}")
    module, trainer_cls = {
        "sim": (SimulatorDataModule, SupervisedTrainer),
        "st": (TwoDomainDataModule, SupervisedTrainer),
        "mme": (TwoDomainMMEDataModule, MMETrainer)}[args.trainType]
    shards = ({} if world is None else
              dict(shard_id=world.rank, num_shards=world.size))
    data = module(args.dataPath, batch_size=args.batch_size, seed=seed,
                  load_into_memory=args.load2memory,
                  device_cache=args.device_cache, device=device, **shards)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)  # the initial weights
        model = build_model(args.arch, 4)
    prof = None
    try:
        trainer = trainer_cls(
            num_cls=4, lr=args.learningRate, decay=args.decay,
            lr_ratio=args.lrRatio, height=args.height, width=args.width,
            gray=args.gray, augment=args.augment, model=model,
            pallas_train=args.pallas_train, fast_train=args.fast_train,
            world=world, device=device)
        if args.trainType == "mme":
            trainer.from_pretrained(args.pretrained_path)
        data.setup()
        prof = _start_profile(trainer.device) if args.profile else None
        _, best_iou, _ = fit(trainer, data, max_epochs=args.max_epochs,
                             out_dir=out_dir, seed=seed,
                             log_every=args.log_every, resume=args.resume)
    finally:
        if prof is not None:
            path = os.path.join(out_dir, "profile", "trace.json")
            prof.stop()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
            logging.info("profiler trace written to %s", path)
            _log_counts(trainer)
        if owned:
            multihost.close_world()
    logging.info("best val_iou %.4f; artifacts in %s", best_iou, out_dir)
    return {"best_iou": best_iou, "out_dir": out_dir}


def _log_counts(trainer) -> None:
    """The process's graph counts and K3a launches (a replay runs no
    Python: the kernels count at the capture), and the K1-K3b launches of
    the trainer's captured step, all and at small planes, its K3a
    own-layer items, all and prefetched, and its optimizers' operations
    (``optim_ops``)."""
    from ..kernels import train_block
    from ..train import graphs

    captured = trainer.graph.counted if trainer.graph is not None else {}
    logging.info("graphs %s; K3a launches %d; captured step %s",
                 graphs.counts, train_block.launches["stage"], captured)


def _start_profile(device):
    """A started ``torch.profiler`` over the host and, on a card, the
    device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


if __name__ == "__main__":
    main()
