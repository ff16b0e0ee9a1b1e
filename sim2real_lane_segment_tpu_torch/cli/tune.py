"""HPO sweep CLI, the reference ``tune.py`` without Ray.

Counterpart of the JAX package's ``cli/tune.py``: tune the MME trainer's
``log_lr ~ U(-4, -2)``, ``log_lrRatio ~ U(-3, 0)`` and ``log_decay ~
U(-8, -1)`` over ``--num_samples`` trials, maximizing the validation
``mean_iou``, with successive halving in place of Ray's ASHA (rungs at
``--grace_period`` epochs times powers of ``--reduction_factor``, capped
at ``--num_epochs``; after each rung the best ``1/reduction_factor`` of
the trials go on).  ``--search tpe`` (default) proposes each trial's
configuration when it starts, from every result so far
(``train.bayesopt.TPEProposer``); ``--search random`` samples uniformly.

    python -m sim2real_lane_segment_tpu_torch.cli.tune \\
        --dataPath simRealData --num_samples 20 --num_epochs 175

One ``MMETrainer`` serves every trial: a trial sets its learning rates
and decay into the trainer's device operands and loads fresh weights
(seeded by the trial) and zeroed optimizer state in place, so under
``--device_cache`` the sweep captures its step as a CUDA graph once.
Between rungs each live trial's state is kept on the host.  In a
launch of several processes (``torchrun``) the trials are sharded
round-robin by rank, each rank runs its own halving over its share under
``<out_dir>/host_<rank>``, and the proposer's seed is offset by the rank.

Each trial writes ``<out_dir>/trial_<id>/metrics.jsonl`` (one line per
epoch: ``loss``, ``mean_accuracy``, ``mean_iou``); ``trials.json`` (every
trial's configuration, epochs, best ``mean_iou`` and whether it was
pruned) is rewritten after every trial, and ``best.json`` at the end.
Three faults of the JAX CLI are not repeated: a trial that starts from
epoch 0 truncates its ``metrics.jsonl`` (JAX appends to a stale one),
both JSON files are replaced atomically, and ``--eval_default`` runs the
default configuration with its own seed (JAX reuses trial 0's).

As in JAX (and the reference), ``log_lrRatio`` is sampled but does not
move MME, whose schedules end at ``lr * 1e-3``; ``--num_cls`` defaults to
4 (the reference hard-coded 3 here).  Runs on the card unless ``main`` is
given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os

from ..core import runtime
from . import common

log = logging.getLogger(__name__)

# the reference's search space (tune.py:63-67)
SEARCH_SPACE = {
    "log_lr": (-4.0, -2.0),
    "log_lrRatio": (-3.0, 0.0),
    "log_decay": (-8.0, -1.0),
}

# the configuration every CLI ships with (lr 1e-3, decay 1e-4)
DEFAULT_CONFIG = {"log_lr": -3.0, "log_lrRatio": 0.0, "log_decay": -4.0}


def make_trainer(*, num_cls: int, augment: bool, arch: str = "67",
                 height: int = 120, width: int = 160, device=None):
    """The one ``MMETrainer`` every trial of the sweep runs on."""
    from ..train.mme import MMETrainer
    from .test import build_model

    return MMETrainer(num_cls=num_cls, augment=augment,
                      model=build_model(arch, num_cls), height=height,
                      width=width, device=device)


def fresh_weights(arch: str, num_cls: int, seed: int) -> dict:
    """The state dict of a model of ``arch`` initialized from ``seed``."""
    import torch

    from .test import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(arch, num_cls).state_dict()


def run_trial(config: dict, data, trainer, *, epochs_from: int,
              epochs_to: int, out_dir: str, seed: int, arch: str,
              state: dict | None = None) -> tuple[dict, float]:
    """Run one trial from epoch ``epochs_from`` to ``epochs_to``: from
    fresh weights (seeded by ``seed``) when ``state`` is None, else from
    ``state`` (``trainer.state_dict()``).  Returns (state, best
    mean_iou over these epochs)."""
    from ..train.loop import (MetricLogger, epoch_generator, run_eval,
                              run_train_epoch)

    trainer.lr = 10 ** config["log_lr"]
    trainer.lr_ratio = 10 ** config["log_lrRatio"]
    trainer.set_decay(10 ** config["log_decay"])
    if state is None:
        trainer.model.load_state_dict(fresh_weights(arch, trainer.num_cls,
                                                    seed))
        trainer.reset_optimizers()
        trainer._folded = None
    else:
        trainer.load_state_dict(state)
    logger = MetricLogger(out_dir)
    if epochs_from == 0:
        open(logger.history_path, "w").close()  # a fresh trial's history
    best = -1.0
    for epoch in range(epochs_from, epochs_to):
        run_train_epoch(trainer, data, epoch_generator(seed, epoch), epoch,
                        logger, 0, None)
        val = run_eval(trainer.eval_step, data.val_batches())
        logger.log(epoch, {"loss": val["loss"], "mean_accuracy": val["acc"],
                           "mean_iou": val["iou"]})
        best = max(best, val["iou"])
    return trainer.state_dict(), best


def rungs(grace_period: int, reduction_factor: int,
          num_epochs: int) -> list[int]:
    """The epochs the successive-halving rungs end at."""
    out, e = [], grace_period
    while e < num_epochs:
        out.append(e)
        e *= reduction_factor
    return out + [num_epochs]


def write_json(path: str, obj) -> None:
    """``obj`` as JSON at ``path``, replaced atomically."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataPath", type=str, required=True,
                   help="Path of database root")
    p.add_argument("--reproducible", action="store_true")
    p.add_argument("--num_samples", type=int, default=20)
    p.add_argument("--num_epochs", type=int, default=175)
    p.add_argument("--grace_period", type=int, default=25)
    p.add_argument("--reduction_factor", type=int, default=4)
    p.add_argument("--num_cls", type=int, default=4)
    p.add_argument("--arch", default="67",
                   choices=["67", "67r", "57", "103", "tiny", "lite",
                            "encdec"])
    p.add_argument("--out_dir", type=str, default="tune_minimax_segmenter")
    p.add_argument("--search", choices=["tpe", "random"], default="tpe",
                   help="first-rung config proposer (the reference used "
                        "BayesOptSearch; tpe is the native equivalent)")
    p.add_argument("--eval_default", action="store_true",
                   help="also run the default config (lr 1e-3, decay "
                        "1e-4) un-pruned to num_epochs and record it in "
                        "best.json")
    common.add_data_args(p)
    common.add_model_args(p)
    return p


def main(args=None, device=None) -> dict:
    """Run the sweep; ``device`` defaults to ``cuda`` and raises without a
    card."""
    from ..data.modules import TwoDomainMMEDataModule
    from ..parallel.multihost import process_index
    from ..train.bayesopt import make_proposer

    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    seed = 42 if args.reproducible else 0
    rank, n_ranks = process_index()

    data = TwoDomainMMEDataModule(args.dataPath, batch_size=args.batch_size,
                                  seed=seed, device_cache=args.device_cache,
                                  device=device)
    data.setup()
    # identically seeded proposers would make every rank propose the same
    # configurations
    proposer = make_proposer(args.search, SEARCH_SPACE,
                             seed=seed + 7919 * rank)
    # proposed lazily at the first rung, so TPE conditions on every
    # earlier trial's result
    trials = [{"id": i, "config": None, "state": None, "epoch": 0,
               "best_iou": -1.0, "alive": True}
              for i in range(args.num_samples)]
    out_dir = args.out_dir
    if n_ranks > 1:
        trials = [t for t in trials if t["id"] % n_ranks == rank]
        out_dir = os.path.join(out_dir, f"host_{rank}")
        log.info("rank %d of %d runs %d trials", rank, n_ranks, len(trials))
    trainer = make_trainer(num_cls=args.num_cls, augment=True,
                           arch=args.arch, height=args.height,
                           width=args.width, device=device)
    os.makedirs(out_dir, exist_ok=True)

    def dump_trials():
        # after every trial, so that a sweep cut short leaves its table
        write_json(os.path.join(out_dir, "trials.json"),
                   [{"id": t["id"], "config": t["config"],
                     "epochs": t["epoch"], "best_iou": t["best_iou"],
                     "pruned": not t["alive"]}
                    for t in trials if t["config"] is not None])

    prev = 0
    for rung in rungs(args.grace_period, args.reduction_factor,
                      args.num_epochs):
        alive = [t for t in trials if t["alive"]]
        log.info("rung %d -> %d epochs: %d trials", prev, rung, len(alive))
        for t in alive:
            if t["config"] is None:
                t["config"] = proposer.propose()
            t["state"], best = run_trial(
                t["config"], data, trainer, epochs_from=t["epoch"],
                epochs_to=rung,
                out_dir=os.path.join(out_dir, f"trial_{t['id']:03d}"),
                seed=seed + t["id"], arch=args.arch, state=t["state"])
            if t["epoch"] == 0:
                proposer.observe(t["config"], best)
            t["epoch"] = rung
            t["best_iou"] = max(t["best_iou"], best)
            log.info("trial %d @%d epochs: best mean_iou %.3f", t["id"],
                     rung, t["best_iou"])
            dump_trials()
        if rung < args.num_epochs:
            alive.sort(key=lambda t: -t["best_iou"])
            keep = max(1, math.ceil(len(alive) / args.reduction_factor))
            for t in alive[keep:]:
                t["alive"], t["state"] = False, None
        prev = rung

    best = max(trials, key=lambda t: t["best_iou"])
    result = {"best_config": best["config"], "best_iou": best["best_iou"],
              "trial": best["id"]}
    if args.eval_default:
        # a seed no trial has (trial i runs seed + i)
        _, d_best = run_trial(
            DEFAULT_CONFIG, data, trainer, epochs_from=0,
            epochs_to=args.num_epochs,
            out_dir=os.path.join(out_dir, "trial_default"),
            seed=seed + args.num_samples, arch=args.arch)
        result.update(default_config=DEFAULT_CONFIG, default_iou=d_best)
        log.info("default config @%d epochs: best mean_iou %.3f",
                 args.num_epochs, d_best)
    write_json(os.path.join(out_dir, "best.json"), result)
    dump_trials()
    print("Best hyperparameters found were: ", best["config"])
    return result


if __name__ == "__main__":
    main()
