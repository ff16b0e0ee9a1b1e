"""Supervised training through ``SupervisedTrainer.run_scan_chunk``, as
``cli.train --pallas_train --augment --device_cache`` trains: the split
on the device, a seeded permutation each epoch, chunks of ``scan_chunk``
steps, on a card one CUDA-graph replay a step.

Set-up builds the trainer from the seed's weights, makes the split, the
draws and the masks on the device, and drives the trainer through its
first ``checked_steps`` steps (rows that all differ, one call of one
step, which captures the graph, then one of the rest); the program's
loss, first gradient and change are read there, and the same trainer
goes on into the window. The window runs whole chunks until its seconds
are over; each chunk's losses are read back (a step whose loss is not
finite has failed). The reference follows the checked steps after the
window, once the program's state is freed.
"""
from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from .. import faults, inputs
from ..harness import PORT
from ..reference import compare
from ..reference import train as ref
from ..trace import Stretch, port_kernels


def _stats_change(now: dict, start: dict) -> dict:
    """Per running-statistics buffer, the norm of its change."""
    return {nm: float((now[nm] - start[nm]).norm()) for nm in now
            if nm.endswith(("running_mean", "running_var"))}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.cfg, ctx.traffic
        self.device = ctx.device

    # -- set-up --------------------------------------------------------

    def setup(self) -> None:
        runtime = importlib.import_module(f"{PORT}.core.runtime")
        build_model = importlib.import_module(f"{PORT}.cli.test").build_model
        sup = importlib.import_module(f"{PORT}.train.supervised")
        self.AugmentDraws = importlib.import_module(
            f"{PORT}.ops.augment").AugmentDraws
        self.package_dir = importlib.import_module(PORT).__path__[0]

        runtime.set_float32_precision()
        cfg, tr, dev, seed = self.cfg, self.tr, self.device, self.ctx.seed
        self.weights = inputs.weights(cfg, seed, dev)
        model = build_model(cfg["arch"], cfg["n_classes"]).to(dev)
        model.load_state_dict(self.weights)
        self.trainer = sup.SupervisedTrainer(
            num_cls=cfg["n_classes"], lr=tr["lr"], decay=tr["weight_decay"],
            height=cfg["height"], width=cfg["width"], augment=True,
            model=model, pallas_train=True, device=dev)
        self.planted = faults.plant_train(self.ctx.faults, self.trainer, sup)

        n, b = tr["split_frames"], tr["batch"]
        h, w = cfg["height"], cfg["width"]
        self.arrays = (inputs.frames(n, h, w, seed, "split", dev),
                       inputs.labels(n, h, w, cfg["n_classes"], seed, dev))
        self.pool = inputs.draws(cfg, tr["augment"], tr["draw_pool_steps"],
                                 b, seed, dev)
        self.masks = inputs.masks(cfg, tr["draw_pool_steps"], b, seed, dev)
        self.rng = np.random.default_rng(inputs.sub_seed(seed, "order"))
        self.gen = torch.Generator().manual_seed(inputs.sub_seed(seed, "gen"))

        # the checked steps: epoch 0's first rows, through the window's call
        k = tr["checked_steps"]
        rows = self.rng.permutation(n)[:k * b].reshape(k, b)
        self.checked = rows
        names = [nm for nm, _ in model.named_parameters()]
        start = {nm: t.detach().clone() for nm, t in
                 model.state_dict().items()}
        logs1 = self.trainer.run_scan_chunk(self.arrays, rows[:1], self.gen,
                                            0, draws=self._draws(0, 1))
        b1 = self.trainer.opt.b1
        grad1 = {nm: float(m.norm()) / (1.0 - b1)
                 for nm, m in zip(names, self.trainer.opt.mu)}
        stats1 = _stats_change(model.state_dict(), start)
        logs2 = self.trainer.run_scan_chunk(self.arrays, rows[1:], self.gen,
                                            0, draws=self._draws(1, k - 1))
        now = model.state_dict()
        self.prog = {
            "loss": [float(v) for v in torch.cat([logs1["tr_loss"],
                                                  logs2["tr_loss"]])],
            "grad1": grad1,
            "delta": {nm: float((now[nm] - start[nm]).norm())
                      for nm in names},
            "stats1": stats1, "stats": _stats_change(now, start)}
        self.step = k
        self.stretch = Stretch(dev) if self.ctx.trace else None
        if self.stretch is not None:
            self.stretch.warm()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _draws(self, first: int, count: int) -> list:
        p = self.tr["draw_pool_steps"]
        out = []
        for s in range(first, first + count):
            d = inputs.step_draws(self.pool, s % p)
            out.append({"draws": self.AugmentDraws(**d),
                        "masks": self.masks[s % p]})
        return out

    # -- window ----------------------------------------------------------

    def window(self, t_open: float) -> dict:
        tr, n, b = self.tr, self.tr["split_frames"], self.tr["batch"]
        chunk = tr["scan_chunk"]
        per_epoch = n // (b * chunk)
        stretch = self.stretch
        chunks, failed, epoch, order = [], 0, 0, None
        t_end = t_open + self.ctx.seconds
        t = t_open
        while t < t_end:
            i = len(chunks)
            if i % per_epoch == 0:
                epoch += 1
                order = self.rng.permutation(n)[:per_epoch * chunk * b] \
                    .reshape(per_epoch, chunk, b)
            profiled = stretch is not None and i == 1
            if profiled:
                stretch.start()
            t0 = time.monotonic()
            logs = self.trainer.run_scan_chunk(
                self.arrays, order[i % per_epoch], self.gen, epoch,
                draws=self._draws(self.step, chunk))
            loss = logs["tr_loss"].cpu()
            if profiled:
                stretch.stop()
            t = time.monotonic()
            failed += int((~torch.isfinite(loss)).sum())
            chunks.append((t0, t, profiled))
            self.step += chunk
        window_s = t - t_open
        steps = len(chunks) * chunk
        rec = {"kind": "train", "cfg": self.cfg, "batch": b,
               "chunk_steps": chunk, "chunks": chunks,
               "images": steps * b, "window_s": window_s}
        if stretch is not None and stretch.prof is not None:
            rec["trace"] = stretch.reduce(port_kernels(self.package_dir))
            rec["trace_steps"] = chunk
        return {"metrics": {"train_images_per_s": steps * b / window_s},
                "attempted": steps, "failed": failed, "rec": rec}

    # -- after the window ------------------------------------------------

    def release(self) -> None:
        images, labels = self.arrays
        rows = torch.as_tensor(self.checked.reshape(-1), device=self.device)
        self.check_images = images.index_select(0, rows)
        self.check_labels = labels.index_select(0, rows)
        k = len(self.checked)
        self.check_draws = [{f: t.clone() for f, t in
                             inputs.step_draws(self.pool, s).items()}
                            for s in range(k)]
        self.check_masks = self.masks[:k].clone()
        self.planted.close()
        del self.trainer, self.arrays, self.pool, self.masks
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, convs=ref.Convs()) -> dict:
        """The reference's checked steps from the same weights, rows,
        draws and masks (``convs``: the precision of its convolutions)."""
        b = self.tr["batch"]
        rows = [torch.arange(i * b, (i + 1) * b, device=self.device)
                for i in range(len(self.checked))]
        return ref.train_steps(self.cfg, self.weights, self.check_images,
                               self.check_labels, rows, self.check_draws,
                               self.check_masks, self.tr["lr"],
                               self.tr["weight_decay"], convs)

    def check(self) -> dict:
        return compare.train_numbers(self.prog, self.reference())
