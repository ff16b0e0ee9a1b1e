"""Deterministic, shard-aware epoch samplers.

Counterpart of ``sim2real_lane_segment_tpu.data.samplers``: every sampler
is a pure function of ``(seed, epoch)`` giving the global index sequence,
sliced per data-parallel shard.  The index arrays are bit-equal to the
JAX package's (same numpy generator, same draws in the same order).

- ``shuffle_epoch``: a uniform shuffle (regime ``sim``);
- ``two_domain_epoch``: the reference's WeightedRandomSampler with weights
  1/len(domain), with replacement, over concat(source, target): each draw
  picks a domain 50/50, then a uniform element of it (regime ``st``);
- ``mme_epoch``: the same draws, each paired with the unlabelled index
  ``idx % n_unlabelled`` (the reference's ParallelDataset, regime ``mme``).
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, epoch: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch]))


def shuffle_epoch(n: int, seed: int, epoch: int) -> np.ndarray:
    return _rng(seed, epoch).permutation(n)


def two_domain_epoch(n_source: int, n_target: int, seed: int,
                     epoch: int) -> np.ndarray:
    """Indices into concat(source, target); source ids are < n_source."""
    rng = _rng(seed, epoch)
    n = n_source + n_target
    pick_target = rng.random(n) < 0.5
    src_idx = rng.integers(0, n_source, n)
    tgt_idx = rng.integers(0, n_target, n) + n_source
    return np.where(pick_target, tgt_idx, src_idx)


def mme_epoch(n_source: int, n_target: int, n_unlabelled: int, seed: int,
              epoch: int) -> tuple[np.ndarray, np.ndarray]:
    labelled = two_domain_epoch(n_source, n_target, seed, epoch)
    return labelled, labelled % n_unlabelled


def shard(indices: np.ndarray, shard_id: int, num_shards: int,
          batch_size: int) -> np.ndarray:
    """One shard's slice of a global index sequence; drops the trailing
    partial global batch so every shard sees the same batches."""
    per_batch = batch_size * num_shards
    n_batches = len(indices) // per_batch
    usable = indices[: n_batches * per_batch].reshape(n_batches, num_shards,
                                                      batch_size)
    return usable[:, shard_id, :].reshape(-1)


def batched(indices: np.ndarray, batch_size: int, drop_last: bool):
    out = []
    for i in range(0, len(indices), batch_size):
        b = indices[i:i + batch_size]
        if drop_last and len(b) < batch_size:
            break
        out.append(b)
    return out
