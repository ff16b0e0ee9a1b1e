"""Fit, validate and test loop with best-checkpoint tracking.

Counterpart of ``sim2real_lane_segment_tpu.train.loop``: per-epoch
validation (loss, acc, dice, iou), the best-``val_iou`` state in
``checkpoints/best.pt`` and the end-of-epoch state in
``checkpoints_latest/latest.pt``, the test pass on the best state at the
end, and ``best_weights.pt``.
Scalars go to ``metrics.jsonl``.  ``resume`` continues a run from its own
checkpoints.  Each epoch draws its dropout masks from a
``torch.Generator`` seeded from ``(seed, epoch)``, so a resumed run
repeats the randomness of an uninterrupted one.

When the trainer has ``run_scan_chunk`` and the data module keeps its
splits on the device (``train_scan_inputs`` is not None), an epoch runs
as chunks of ``SCAN_CHUNK`` steps through ``run_scan_chunk`` (the JAX
``_run_train_epoch_scanned``): the same batches, draws, logged values and
cadence as the per-batch loop, with the chunk's logs read once, at its
end.  A trainer without it (distillation) runs the per-batch loop, on
batches gathered on the device where the module caches its splits, as
the JAX ``fit`` does.  The JAX loop's retries of transient backend errors and its retreat
to the per-batch path are not ported: a failure raises.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from ..data.prefetch import background_batches
from ..ops.metrics import summarize_weighted
from .checkpoint import atomic_save, load_train_state, save_train_state

log = logging.getLogger(__name__)


class MetricLogger:
    """Appends ``{"step": ..., **scalars}`` lines to ``metrics.jsonl``."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.history_path = os.path.join(out_dir, "metrics.jsonl")

    def log(self, step: int, scalars: dict) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        with open(self.history_path, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")


def run_eval(eval_step: Callable, batches: Iterable) -> dict:
    outs = [{k: float(v) for k, v in eval_step(x, y).items()}
            for x, y in batches]
    if not outs:
        return {"loss": 0.0, "acc": 0.0, "dice": 0.0, "iou": 0.0}
    return summarize_weighted(outs)


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The dropout generator of one epoch, a pure function of its seeds."""
    s = np.random.SeedSequence([seed, epoch]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(s))


def _last_logged_step(history_path: str) -> int:
    try:
        with open(history_path) as f:
            return max((json.loads(line).get("step", 0) for line in f
                        if line.strip()), default=0)
    except OSError:
        return 0


# steps a chunk of the multi-step dispatch (the JAX loop's _SCAN_CHUNK)
SCAN_CHUNK = 32


def _run_train_epoch(trainer, data, gen, epoch, logger, global_step,
                     log_every) -> tuple[int, int]:
    """One epoch of per-batch steps; returns (steps, global step)."""
    n_steps = 0
    for batch in background_batches(lambda e=epoch: data.train_batches(e)):
        logs = trainer.default_step_fn(batch, gen, epoch)
        n_steps += 1
        global_step += 1
        if log_every and global_step % log_every == 0:
            logger.log(global_step, {f"train/{k}": v
                                     for k, v in logs.items()})
    return n_steps, global_step


def _run_train_epoch_scanned(trainer, scan, gen, epoch, logger, global_step,
                             log_every) -> tuple[int, int]:
    """One epoch as ``run_scan_chunk`` calls of ``SCAN_CHUNK`` steps over
    the device-resident split; ``scan`` is the module's (device arrays,
    index matrix [n, ...])."""
    arrays, idx = scan
    for i in range(0, len(idx), SCAN_CHUNK):
        chunk = idx[i:i + SCAN_CHUNK]
        logs = trainer.run_scan_chunk(arrays, chunk, gen, epoch)
        rows = [j for j in range(len(chunk))
                if log_every and (global_step + j + 1) % log_every == 0]
        if rows:
            names = list(logs)
            values = torch.stack([logs[k] for k in names], 1).cpu()
            for j in rows:
                logger.log(global_step + j + 1,
                           {f"train/{k}": v for k, v in zip(names,
                                                            values[j])})
        global_step += len(chunk)
    return len(idx), global_step


def run_train_epoch(trainer, data, gen, epoch, logger, global_step,
                    log_every) -> tuple[int, int]:
    """One epoch: chunks of ``run_scan_chunk`` over the device-resident
    split where the trainer and the module have one, else per-batch
    steps.  Logs the train scalars every ``log_every`` steps (None:
    never).  Returns (steps, global step)."""
    scan = (getattr(data, "train_scan_inputs", lambda e: None)(epoch)
            if hasattr(trainer, "run_scan_chunk") else None)
    if scan is None:
        return _run_train_epoch(trainer, data, gen, epoch, logger,
                                global_step, log_every)
    return _run_train_epoch_scanned(trainer, scan, gen, epoch, logger,
                                    global_step, log_every)


def fit(trainer, data, *, max_epochs: int, out_dir: str, seed: int = 42,
        log_every: int = 50, resume: bool = False) -> tuple:
    """Train ``trainer`` on ``data`` with per-epoch validation.

    Returns (best state dict, best val_iou, logger); the trainer holds the
    best state when this returns.
    """
    logger = MetricLogger(out_dir)
    best_path = os.path.join(out_dir, "checkpoints", "best.pt")
    latest_path = os.path.join(out_dir, "checkpoints_latest", "latest.pt")
    best_iou, best_state = -1.0, trainer.state_dict()
    start_epoch, global_step = 0, 0
    if resume:
        try:
            ck = load_train_state(best_path)
            best_iou = ck["metrics"]["val_iou"]
            best_state = {"model": ck["model"], "optimizer": ck["optimizer"]}
            trainer.load_state_dict(best_state)
            start_epoch = ck["epoch"] + 1
        except FileNotFoundError:
            pass
        try:
            ck = load_train_state(latest_path)
            if ck["epoch"] + 1 > start_epoch:
                trainer.load_state_dict(ck)
                start_epoch = ck["epoch"] + 1
        except FileNotFoundError:
            pass
        global_step = _last_logged_step(logger.history_path)
        if start_epoch:
            log.info("resumed %s at epoch %d (best val_iou %.3f, step %d)",
                     out_dir, start_epoch, best_iou, global_step)

    hparams = {"lr": trainer.lr, "decay": trainer.decay,
               "lrRatio": trainer.lr_ratio, "num_cls": trainer.num_cls}
    for epoch in range(start_epoch, max_epochs):
        t0 = time.time()
        n_steps, global_step = run_train_epoch(
            trainer, data, epoch_generator(seed, epoch), epoch, logger,
            global_step, log_every)
        val = run_eval(trainer.eval_step, data.val_batches())
        logger.log(global_step, {f"val/{k}": v for k, v in val.items()})
        log.info("epoch %d: %d steps in %.1fs, val_iou=%.3f val_acc=%.2f",
                 epoch, n_steps, time.time() - t0, val["iou"], val["acc"])
        state = trainer.state_dict()
        save_train_state(latest_path, epoch, state, metrics=val)
        if val["iou"] > best_iou:
            best_iou, best_state = val["iou"], state
            save_train_state(best_path, epoch, state,
                             metrics={"val_iou": val["iou"]},
                             hparams=hparams)

    trainer.load_state_dict(best_state)
    test = run_eval(trainer.eval_step, data.test_batches())
    logger.log(global_step, {f"test/{k}": v for k, v in test.items()})
    log.info("test: %s", test)
    # reference train.py:73-75 saves best_weights.pt beside the checkpoint
    atomic_save(best_state["model"], os.path.join(out_dir, "best_weights.pt"))
    return best_state, best_iou, logger
