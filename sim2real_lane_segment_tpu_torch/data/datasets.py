"""Directory-contract dataset reader.

Counterpart of ``sim2real_lane_segment_tpu.data.datasets``: a dataset
directory holds ``input/*.png`` and (optionally) ``label/*.png`` with
matching names.  File lists are sorted; images are read as BGR and labels
as gray (``data.png``, no cv2); ``preload`` fills an in-RAM cache on a
thread pool, and ``read_batch`` stacks an index list into uint8 arrays,
resizing frames of another size through ``ops.resize`` (bilinear for
images, nearest for labels, cv2's semantics).
"""
from __future__ import annotations

import concurrent.futures as cf
import glob
import logging
import os
from typing import Sequence

import numpy as np
import torch

from ..ops.resize import resize_bilinear, resize_nearest_label
from .png import read_png

log = logging.getLogger(__name__)


class RightLaneDataset:
    """Reader for one ``input/`` (+ ``label/``) PNG directory pair."""

    def __init__(self, data_path: str, have_labels: bool = True, *,
                 load_into_memory: bool = False, num_threads: int = 8):
        self.have_labels = have_labels
        input_dir = os.path.join(data_path, "input")
        label_dir = os.path.join(data_path, "label")
        if not os.path.isdir(input_dir) or (
                have_labels and not os.path.isdir(label_dir)):
            raise ValueError(
                f"Directory structure under {data_path} is not complete!")
        self.input_paths = sorted(glob.glob(os.path.join(input_dir, "*.png")))
        if not self.input_paths:
            log.warning("No data found at %s!", data_path)
        self.label_paths = None
        if have_labels:
            self.label_paths = sorted(glob.glob(os.path.join(label_dir,
                                                             "*.png")))
            if len(self.input_paths) != len(self.label_paths):
                raise FileNotFoundError(
                    f"Different input and target count encountered at "
                    f"{data_path}!")
        self._cache: list | None = None
        if load_into_memory:
            self.preload(num_threads)

    def __len__(self) -> int:
        return len(self.input_paths)

    def _read(self, index: int):
        x = read_png(self.input_paths[index], color=True)
        y = (read_png(self.label_paths[index], color=False)
             if self.have_labels else None)
        return x, y

    def __getitem__(self, index: int):
        if self._cache is not None:
            return self._cache[index]
        return self._read(index)

    def preload(self, num_threads: int = 8) -> None:
        with cf.ThreadPoolExecutor(num_threads) as ex:
            self._cache = list(ex.map(self._read, range(len(self))))

    def read_batch(self, indices: Sequence[int],
                   size: tuple[int, int] | None = None):
        """Stack ``indices`` into uint8 (N, H, W, 3) images and (N, H, W)
        labels (None without labels), resized to ``size`` (h, w) where a
        frame differs."""
        xs, ys = [], []
        for i in indices:
            x, y = _maybe_resize(*self[int(i)], size)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), (np.stack(ys) if self.have_labels else None)

    @property
    def image_shape(self):
        return self[0][0].shape if len(self) else None


def _maybe_resize(x, y, size: tuple[int, int] | None):
    if size is None or x.shape[:2] == size:
        return x, y
    h, w = size
    xt = resize_bilinear(torch.from_numpy(x), h, w)
    x = torch.round(xt).clamp(0, 255).to(torch.uint8).numpy()
    if y is not None and y.shape[:2] != size:
        y = resize_nearest_label(torch.from_numpy(y), h, w).numpy()
    return x, y
