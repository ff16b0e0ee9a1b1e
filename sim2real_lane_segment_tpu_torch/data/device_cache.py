"""Device-resident dataset cache: a split uploaded to the card once, batch
rows gathered there by index.

Counterpart of the JAX package's ``data/device_cache.py``.  The host
pipeline reads, stacks and copies every batch; a ``DeviceCachedView``
holds the whole split on the device as one uint8 tensor (images [N, H,
W, 3], labels [N, H, W]) and each step gathers its rows there
(``index_select``) from an index vector, so only the indices cross the
host link.  ``from_datasets`` concatenates the index spaces of several
datasets, as the two-domain samplers index ``concat(source, target)``.

The upload fills a tensor allocated up front, in row chunks of about
256 MB, so it never needs twice the split's memory.  It does not fall
back: an upload that does not fit raises ``MemoryError`` naming the split
and its bytes (the JAX view degrades to host reads after a failed upload
or gather, and its fit loop frees the caches under memory pressure; both
would hide the device).
"""
from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)

CHUNK_BYTES = 256 * 1024 * 1024


def _allocate(shape, device: torch.device, name: str,
              nbytes: int) -> torch.Tensor:
    """An uninitialized uint8 tensor; ``nbytes``: the whole split's."""
    try:
        return torch.empty(shape, dtype=torch.uint8, device=device)
    except (RuntimeError, MemoryError) as e:  # torch.OutOfMemoryError too
        raise MemoryError(
            f"device cache: split {name!r} needs {nbytes:,} bytes on "
            f"{device} and does not fit: {e}") from e


def to_device_index(indices, device: torch.device) -> torch.Tensor:
    """An int64 index array on ``device``; to a card from pinned memory,
    asynchronously (a copy from pageable memory would wait for the
    stream)."""
    idx = torch.as_tensor(np.asarray(indices), dtype=torch.int64)
    if device.type == "cuda":
        idx = idx.pin_memory()
    return idx.to(device, non_blocking=True)


def _rows_per_chunk(row_shape) -> int:
    return max(1, CHUNK_BYTES // max(1, int(np.prod(row_shape))))


class DeviceCachedView:
    """One split on a device: ``images`` uint8 [N, H, W, 3] and ``labels``
    uint8 [N, H, W] (None for an unlabelled split)."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor | None,
                 name: str = "split"):
        self.images, self.labels, self.name = images, labels, name

    @property
    def nbytes(self) -> int:
        return sum(t.numel() for t in (self.images, self.labels)
                   if t is not None)

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray | None,
                    device, name: str = "split") -> "DeviceCachedView":
        """Upload host arrays in row chunks into tensors allocated first."""
        device = torch.device(device)
        nbytes = images.nbytes + (0 if labels is None else labels.nbytes)
        out = [None if a is None else _allocate(a.shape, device, name, nbytes)
               for a in (images, labels)]
        for dst, src in zip(out, (images, labels)):
            if src is None:
                continue
            rows = _rows_per_chunk(src.shape[1:])
            for i in range(0, len(src), rows):
                dst[i:i + rows].copy_(torch.from_numpy(
                    np.ascontiguousarray(src[i:i + rows])))
        view = cls(*out, name=name)
        log.info("device cache: %s, %d frames, %d bytes on %s", name,
                 len(images), view.nbytes, device)
        return view

    @classmethod
    def from_datasets(cls, datasets: Sequence, size: tuple[int, int] | None,
                      device, name: str | None = None) -> "DeviceCachedView":
        """concat(*datasets) (``RightLaneDataset``s), read at ``size`` (h,
        w) in row chunks straight into the device tensors: the host holds
        one chunk at a time."""
        device = torch.device(device)
        name = name or "split"
        n = sum(len(d) for d in datasets)
        first = next((d for d in datasets if len(d)), None)
        if first is None:
            h, w = size or (0, 0)
        else:
            h, w = size or first.image_shape[:2]
        have_labels = all(d.have_labels for d in datasets)
        nbytes = n * h * w * (4 if have_labels else 3)
        images = _allocate((n, h, w, 3), device, name, nbytes)
        labels = (_allocate((n, h, w), device, name, nbytes) if have_labels
                  else None)
        rows = _rows_per_chunk((h, w, 4))
        off = 0
        for ds in datasets:
            for i in range(0, len(ds), rows):
                x, y = ds.read_batch(range(i, min(i + rows, len(ds))),
                                     (h, w))
                images[off:off + len(x)].copy_(torch.from_numpy(x))
                if labels is not None:
                    labels[off:off + len(x)].copy_(torch.from_numpy(y))
                off += len(x)
        view = cls(images, labels, name=name)
        log.info("device cache: %s, %d frames, %d bytes on %s", name, n,
                 view.nbytes, device)
        return view

    def gather(self, indices) -> tuple:
        """The rows ``indices`` as (images, labels or None) on the device,
        the ``RightLaneDataset.read_batch`` contract."""
        idx = to_device_index(indices, self.images.device)
        return (self.images.index_select(0, idx),
                None if self.labels is None
                else self.labels.index_select(0, idx))
