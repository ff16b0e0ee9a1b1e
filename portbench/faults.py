"""Faults planted in the program under test, to show that ``correct``
catches them: the harness's own tests plant them at a small size, and
``calibrate.py`` reads them on the chip at the cell's size.

- ``unchanged``: a training step that leaves the state as it was (no
  optimiser update, no running-statistics update).
- ``half_batch``: the loss taken over the first half of the batch only.
- ``altered``: every served mask's classes shifted by one where the
  program produces them.
"""
from __future__ import annotations

import contextlib
from unittest import mock

TRAIN = ("unchanged", "half_batch")
SERVE = ("altered",)


def plant_train(faults, trainer, supervised) -> contextlib.ExitStack:
    stack = contextlib.ExitStack()
    if "unchanged" in faults:
        stack.enter_context(mock.patch.object(trainer.opt, "step",
                                              lambda *a, **k: None))
        stack.enter_context(mock.patch.object(
            supervised, "apply_batch_stats", lambda *a, **k: None))
    if "half_batch" in faults:
        real = supervised.weighted_cross_entropy

        def half(out, y, n_cls):
            h = out.shape[0] // 2
            return real(out[:h], y[:h], n_cls)

        stack.enter_context(mock.patch.object(
            supervised, "weighted_cross_entropy", half))
    return stack


def plant_serve(faults, predict_fn, n_cls: int):
    if "altered" not in faults:
        return predict_fn

    def altered(frames):
        return (predict_fn(frames) + 1) % n_cls

    return altered
