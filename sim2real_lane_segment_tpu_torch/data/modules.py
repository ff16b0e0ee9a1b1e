"""Data modules: host batch producers for the training regimes.

Counterpart of the JAX package's ``data/modules.py``.  Each module hands
uint8 batches to the trainer, which transforms them on the card:

- ``SimulatorDataModule``: ``train``/``valid``/``test`` under one root
  (regime ``sim``);
- ``TwoDomainDataModule``: ``source/`` and ``target/train`` drawn 50/50
  per sample; valid and test are both ``target/test`` (regime ``st``);
- ``TwoDomainMMEDataModule``: also pairs every labelled draw with a
  frame of ``target/unlabelled`` (regime ``mme``); requires
  len(labelled) <= len(unlabelled), as the reference does.

Train batches follow the pure ``(seed, epoch)`` samplers with the last
partial batch dropped.  The device-resident split cache and the
per-process shards of data parallelism are not ported yet.
"""
from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from . import samplers
from .datasets import RightLaneDataset, _maybe_resize

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


class TwoDomainDataModule(BaseDataModule):
    def setup(self) -> None:
        target = os.path.join(self.data_path, "target")
        self.datasets["source"] = RightLaneDataset(
            os.path.join(self.data_path, "source"), True,
            load_into_memory=self.load_into_memory)
        self.datasets["targetTrain"] = RightLaneDataset(
            os.path.join(target, "train"), True,
            load_into_memory=self.load_into_memory)
        test = RightLaneDataset(os.path.join(target, "test"), True)
        # reference: val == test == target/test (dataModules.py:87-92)
        self.datasets["valid"] = self.datasets["test"] = test
        shape = self.datasets["targetTrain"].image_shape
        if shape is not None:
            self.native_size = (shape[0], shape[1])

    def _concat_read(self, indices) -> Batch:
        """Rows of concat(source, target/train), at ``native_size``."""
        src, tgt = self.datasets["source"], self.datasets["targetTrain"]
        xs, ys = [], []
        for i in indices:
            i = int(i)
            x, y = src[i] if i < len(src) else tgt[i - len(src)]
            x, y = _maybe_resize(x, y, self.native_size)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys)

    def train_batches(self, epoch: int) -> Iterator[Batch]:
        idx = samplers.two_domain_epoch(
            len(self.datasets["source"]), len(self.datasets["targetTrain"]),
            self.seed, epoch)
        for b in samplers.batched(idx, self.batch_size, drop_last=True):
            yield self._concat_read(b)


class TwoDomainMMEDataModule(TwoDomainDataModule):
    def setup(self) -> None:
        super().setup()
        self.datasets["targetUnlabelled"] = RightLaneDataset(
            os.path.join(self.data_path, "target", "unlabelled"), False,
            load_into_memory=self.load_into_memory)
        n_labelled = (len(self.datasets["source"])
                      + len(self.datasets["targetTrain"]))
        if n_labelled > len(self.datasets["targetUnlabelled"]):
            raise ValueError(
                "MME requires len(labelled) <= len(unlabelled) "
                "(reference dataModules.py:112)")

    def train_batches(self, epoch: int):
        """Yields ``((x_labelled, y), x_unlabelled)``."""
        unl = self.datasets["targetUnlabelled"]
        lab_idx, unl_idx = samplers.mme_epoch(
            len(self.datasets["source"]), len(self.datasets["targetTrain"]),
            len(unl), self.seed, epoch)
        for lb, ub in zip(
                samplers.batched(lab_idx, self.batch_size, drop_last=True),
                samplers.batched(unl_idx, self.batch_size, drop_last=True)):
            x_unl, _ = unl.read_batch(ub, self.native_size)
            yield self._concat_read(lb), x_unl
