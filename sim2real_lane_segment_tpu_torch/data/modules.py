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
partial batch dropped.  With ``device_cache=True`` every split lives on
``device`` (``device_cache.DeviceCachedView``, built at first use, keyed
by dataset identity so that the two-domain valid and test splits share
one copy): train, validation and test batches are gathered there, and
``train_scan_inputs`` gives the fit loop's multi-step dispatch the
device arrays and the epoch's index matrix.  Under data parallelism
(``cli.train --dp``) each rank's module reads its shard of every epoch's
train indices (``samplers.shard``: ``shard_id`` of ``num_shards``, the
trailing partial global batch dropped) and caches the whole splits, from
which it gathers its shard's rows; evaluation reads every batch whole.
"""
from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from ..core.runtime import resolve_device
from . import samplers
from .datasets import RightLaneDataset, _maybe_resize
from .device_cache import DeviceCachedView

Batch = Tuple[np.ndarray, np.ndarray | None]


class BaseDataModule:
    """``device_cache``: keep the splits on ``device`` (which defaults to
    ``cuda`` and raises without a card; only read with the cache)."""

    def __init__(self, data_path: str, *, batch_size: int = 32,
                 seed: int = 42, load_into_memory: bool = False,
                 device_cache: bool = False, device=None, shard_id: int = 0,
                 num_shards: int = 1):
        self.data_path = data_path
        self.batch_size = batch_size
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.load_into_memory = load_into_memory
        self.device_cache = device_cache
        self.device = resolve_device(device) if device_cache else None
        self._views: dict[tuple, DeviceCachedView] = {}
        self.datasets: dict[str, RightLaneDataset] = {}
        # the (h, w) every host read is brought to, from the train split
        self.native_size: tuple[int, int] | None = None

    def setup(self) -> None:
        raise NotImplementedError

    def _train_epoch_indices(self, epoch: int) -> np.ndarray:
        raise NotImplementedError

    def train_batches(self, epoch: int) -> Iterator[Batch]:
        for b in samplers.batched(self._train_epoch_indices(epoch),
                                  self.batch_size, drop_last=True):
            yield self._read_train(b)

    def train_scan_inputs(self, epoch: int):
        """The multi-step dispatch's inputs (``train.loop``): the train
        split's device arrays and the epoch's batch index matrix [n, B]
        (``run_scan_chunk`` reads both), or None without the cache or
        when the epoch has no whole batch."""
        if not self.device_cache:
            return None
        view = self._view(*self._train_datasets())
        idx = self._train_epoch_indices(epoch)
        n = len(idx) // self.batch_size
        if n == 0:
            return None
        return ((view.images, view.labels),
                np.asarray(idx[:n * self.batch_size], np.int32).reshape(
                    n, self.batch_size))

    def _train_datasets(self) -> tuple:
        raise NotImplementedError

    def _shard(self, indices: np.ndarray) -> np.ndarray:
        """This module's shard of an epoch's global index sequence."""
        return samplers.shard(indices, self.shard_id, self.num_shards,
                              self.batch_size)

    def _view(self, *datasets: RightLaneDataset) -> DeviceCachedView:
        """concat(*datasets) on the device, uploaded at the first call and
        keyed by dataset identity."""
        key = tuple(id(d) for d in datasets)
        if key not in self._views:
            names = {id(d): k for k, d in self.datasets.items()}
            self._views[key] = DeviceCachedView.from_datasets(
                datasets, self.native_size, self.device,
                name="+".join(names.get(id(d), "?") for d in datasets))
        return self._views[key]

    def _read_train(self, indices) -> Batch:
        if self.device_cache:
            return self._view(*self._train_datasets()).gather(indices)
        return self._host_read_train(indices)

    def _eval_batches(self, ds: RightLaneDataset) -> Iterator[Batch]:
        view = self._view(ds) if self.device_cache else None
        for b in samplers.batched(np.arange(len(ds)), self.batch_size,
                                  drop_last=False):
            yield view.gather(b) if view else ds.read_batch(b,
                                                            self.native_size)

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

    def _train_datasets(self) -> tuple:
        return (self.datasets["train"],)

    def _host_read_train(self, indices) -> Batch:
        return self.datasets["train"].read_batch(indices, self.native_size)

    def _train_epoch_indices(self, epoch: int) -> np.ndarray:
        return self._shard(samplers.shuffle_epoch(
            len(self.datasets["train"]), self.seed, epoch))


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

    def _train_datasets(self) -> tuple:
        # the samplers' ids index concat(source, target/train)
        return self.datasets["source"], self.datasets["targetTrain"]

    def _host_read_train(self, indices) -> Batch:
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

    def _train_epoch_indices(self, epoch: int) -> np.ndarray:
        return self._shard(samplers.two_domain_epoch(
            len(self.datasets["source"]), len(self.datasets["targetTrain"]),
            self.seed, epoch))


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

    def _mme_epoch(self, epoch: int):
        lab, unl = samplers.mme_epoch(
            len(self.datasets["source"]), len(self.datasets["targetTrain"]),
            len(self.datasets["targetUnlabelled"]), self.seed, epoch)
        return self._shard(lab), self._shard(unl)

    def _read_unlabelled(self, indices) -> np.ndarray:
        unl = self.datasets["targetUnlabelled"]
        if self.device_cache:
            return self._view(unl).gather(indices)[0]
        return unl.read_batch(indices, self.native_size)[0]

    def train_scan_inputs(self, epoch: int):
        """(labelled images, labels, unlabelled images) on the device and
        the index matrix [n, 2, B] pairing each step's labelled rows (0,
        concat(source, target/train) ids) with its unlabelled rows (1), or
        None (``BaseDataModule.train_scan_inputs``)."""
        if not self.device_cache:
            return None
        lab = self._view(*self._train_datasets())
        unl = self._view(self.datasets["targetUnlabelled"])
        lab_idx, unl_idx = self._mme_epoch(epoch)
        n = min(len(lab_idx), len(unl_idx)) // self.batch_size
        if n == 0:
            return None
        cut = n * self.batch_size
        idx = np.stack([np.asarray(lab_idx[:cut], np.int32)
                        .reshape(n, self.batch_size),
                        np.asarray(unl_idx[:cut], np.int32)
                        .reshape(n, self.batch_size)], axis=1)
        return (lab.images, lab.labels, unl.images), idx

    def train_batches(self, epoch: int):
        """Yields ``((x_labelled, y), x_unlabelled)``."""
        lab_idx, unl_idx = self._mme_epoch(epoch)
        for lb, ub in zip(
                samplers.batched(lab_idx, self.batch_size, drop_last=True),
                samplers.batched(unl_idx, self.batch_size, drop_last=True)):
            yield self._read_train(lb), self._read_unlabelled(ub)
