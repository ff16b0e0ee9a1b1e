"""Data modules: host batch producers for the training regimes.

Counterpart of the JAX package's ``data/modules.py`` for regime ``sim``:
``SimulatorDataModule`` reads ``train``/``valid``/``test`` under one root
and hands uint8 batches to the trainer, which transforms them on the
card.  Train batches follow the pure ``(seed, epoch)`` sampler with the
last partial batch dropped.  The two-domain modules (``st``, ``mme``),
the device-resident split cache and the per-process shards of data
parallelism are not ported yet.
"""
from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from . import samplers
from .datasets import RightLaneDataset

Batch = Tuple[np.ndarray, np.ndarray | None]


class BaseDataModule:
    def __init__(self, data_path: str, *, batch_size: int = 32,
                 seed: int = 42, load_into_memory: bool = False):
        self.data_path = data_path
        self.batch_size = batch_size
        self.seed = seed
        self.load_into_memory = load_into_memory
        self.datasets: dict[str, RightLaneDataset] = {}
        # the (h, w) every host read is brought to, from the train split
        self.native_size: tuple[int, int] | None = None

    def setup(self) -> None:
        raise NotImplementedError

    def train_batches(self, epoch: int) -> Iterator[Batch]:
        raise NotImplementedError

    def _eval_batches(self, ds: RightLaneDataset) -> Iterator[Batch]:
        for b in samplers.batched(np.arange(len(ds)), self.batch_size,
                                  drop_last=False):
            yield ds.read_batch(b, self.native_size)

    def val_batches(self) -> Iterator[Batch]:
        return self._eval_batches(self.datasets["valid"])

    def test_batches(self) -> Iterator[Batch]:
        return self._eval_batches(self.datasets["test"])


class SimulatorDataModule(BaseDataModule):
    def setup(self) -> None:
        for split in ("train", "valid", "test"):
            self.datasets[split] = RightLaneDataset(
                os.path.join(self.data_path, split), True,
                load_into_memory=self.load_into_memory and split != "test")
        shape = self.datasets["train"].image_shape
        if shape is not None:
            self.native_size = (shape[0], shape[1])

    def train_batches(self, epoch: int) -> Iterator[Batch]:
        ds = self.datasets["train"]
        idx = samplers.shuffle_epoch(len(ds), self.seed, epoch)
        for b in samplers.batched(idx, self.batch_size, drop_last=True):
            yield ds.read_batch(b, self.native_size)
