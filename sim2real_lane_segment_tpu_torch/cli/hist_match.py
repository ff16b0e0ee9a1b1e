"""Histogram-matching CLI, the reference ``hist_match_datasets.py``.

Counterpart of the JAX package's ``cli/hist_match.py``, with its flags:
``--ds_source`` (rewritten in place), ``--ds_reference``, ``--no_shuffle``
(skips the shuffle; the reference's flag did the opposite), ``--workers``
(accepted; batching replaces the thread pool) and ``--batch_size``:

    python -m sim2real_lane_segment_tpu_torch.cli.hist_match \\
        --ds_source simData/train --ds_reference realData/unlabelled

Each source frame is matched to a reference frame picked through an
unseeded ``random.shuffle`` of the reference indices (as the JAX CLI
does), ``--batch_size`` frames at a time through
``ops.histmatch.match_histograms_batch`` on the card, and written back
over its PNG.  Runs on the card unless ``main`` is given
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging
import random

import numpy as np
import torch

from ..core.runtime import resolve_device
from . import common

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ds_source", type=str, required=True,
                   help="Dataset wanted to be changed.")
    p.add_argument("--ds_reference", type=str, required=True,
                   help="Dataset of matching reference.")
    p.add_argument("--no_shuffle", action="store_true",
                   help="Skip shuffling reference images before matching.")
    p.add_argument("--workers", type=int, default=4,
                   help="Accepted for interface parity (batching replaces "
                        "threads).")
    p.add_argument("--batch_size", type=int, default=16)
    return p


def main(args=None, device=None) -> int:
    """Match every source frame in place; returns the frame count.
    ``device`` defaults to ``cuda`` and raises without a card."""
    from ..data.datasets import RightLaneDataset
    from ..ops.histmatch import match_histograms_batch

    common.setup_logging()
    args = build_parser().parse_args(args)
    device = resolve_device(device)
    ds_source = RightLaneDataset(args.ds_source, have_labels=False)
    ds_reference = RightLaneDataset(args.ds_reference, have_labels=False)

    ref_idxes = list(range(len(ds_reference)))
    if not args.no_shuffle:
        random.shuffle(ref_idxes)

    n = len(ds_source)
    log.info("Matching histograms of %d images on %s...", n, device)
    for start in range(0, n, args.batch_size):
        idxs = range(start, min(start + args.batch_size, n))
        srcs = np.stack([ds_source[i][0] for i in idxs])
        refs = np.stack([ds_reference[ref_idxes[i % len(ref_idxes)]][0]
                         for i in idxs])
        matched = match_histograms_batch(
            torch.from_numpy(srcs).to(device),
            torch.from_numpy(refs).to(device)).cpu().numpy()
        for j, i in enumerate(idxs):
            ds_source[i] = matched[j]
    log.info("Finished matching histograms (%d images).", n)
    return n


if __name__ == "__main__":
    main()
