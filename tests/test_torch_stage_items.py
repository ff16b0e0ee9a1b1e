"""K3a's own-layer items: ``train_block.stage_item_counts`` (what each
tensor-core K3a launch adds to ``stage_items``) against a count walked
block by block at every dense-layer site of FCDenseNet57, 67 and 103, the
step counters that carry the items to the ``train.capture`` span, and the
``ktrain.stage_prefetch_pct`` reader.  The counts are host arithmetic on
the launch's grid, so all of it runs on the CPU; imports neither JAX nor
the JAX package."""
import importlib
import itertools
import math
from collections import deque

import pytest
from torch_sites import DENSE_SITES, DENSE_SITES_57, DENSE_SITES_103

from portbench import harness
from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

SMS = 132   # one own-layer block per SM of an H100
RING = 2    # ring stages a block fills before its first product


def _walked(c, b, h, w):
    """(items, prefetched) of one launch, walked block by block: chunks of
    at most four 16-channel units, evenly sized; each chunk's splits take
    ``ceil(items / splits)`` consecutive (image, tile) items; a block's
    producer loads its first RING items before any product runs and every
    later item once the item RING before it has released its stage."""
    n16 = math.ceil(c / 16)
    units = math.ceil(n16 / math.ceil(n16 / 4))
    chunks = math.ceil(n16 / units)
    items = b * math.ceil(h / 12) * math.ceil(w / 16)
    splits = max(1, min(items, SMS // chunks))
    per = math.ceil(items / splits)
    total = prefetched = 0
    for _chunk in range(chunks):
        for s in range(splits):
            for k, _item in enumerate(range(s * per,
                                            min(items, (s + 1) * per))):
                total += 1
                prefetched += k >= RING
    return total, prefetched


SITES = ([("67", *s) for s in DENSE_SITES]
         + [("57", *s) for s in DENSE_SITES_57]
         + [("103", *s) for s in DENSE_SITES_103])


@pytest.mark.parametrize("site", SITES, ids=lambda s: "%s_c%d_%dx%d" % s)
def test_stage_item_counts_at_every_site(site):
    """The trained batch, B=32, and the captured B=4 of ``chip_smoke.py``
    phase 26."""
    _, c, h, w = site
    for b in (32, 4):
        assert ktb.stage_item_counts(c, b, h, w) == _walked(c, b, h, w)


@pytest.mark.parametrize("c,b,h,w,want", [
    # one chunk of 48 channels, 3,200 items over 132 splits: 128 blocks
    # of 25, each prefetching all but its first two
    (48, 32, 120, 160, (3200, 128 * 23)),
    # 1,072 channels: 17 chunks of 64; 32 one-tile images over 7 splits
    # of 5 (the last takes 2): 6 * 3 prefetched a chunk
    (1072, 32, 3, 5, (17 * 32, 17 * 18)),
    # 272 channels: 5 chunks of 64, 26 splits of 100 / 26 -> 4 items
    # (25 blocks of 4): 2 each
    (272, 1, 120, 160, (5 * 100, 5 * 25 * 2)),
    # one item a block: nothing to prefetch
    (48, 1, 3, 5, (1, 0)),
    # two items a block: both loaded before the first product
    (1072, 14, 3, 5, (17 * 14, 0)),
])
def test_stage_item_counts_by_hand(c, b, h, w, want):
    assert ktb.stage_item_counts(c, b, h, w) == want


@pytest.mark.parametrize("sites,want", [
    (DENSE_SITES, (153376, 139772)), (DENSE_SITES_57, (92064, 81866)),
    (DENSE_SITES_103, (163840, 141379))], ids=["67", "57", "103"])
def test_a_trained_steps_items_are_mostly_prefetched(sites, want):
    """A B=32 step's K3a items, all and prefetched: 91%, 89% and 86% of
    them load while an earlier item's products run."""
    got = [ktb.stage_item_counts(c, 32, h, w) for c, h, w in sites]
    items, prefetched = (sum(i for i, _ in got), sum(p for _, p in got))
    assert (items, prefetched) == want
    assert prefetched >= 0.8 * items


def test_own_layer_splits_fill_one_block_an_sm():
    for c, h, w in DENSE_SITES + DENSE_SITES_57 + DENSE_SITES_103:
        chunks, _ = ktb.mma_stage_chunks(c)
        splits = ktb.mma_stage_splits(c, 32, h, w)
        assert chunks * splits <= SMS
        assert splits == min(32 * ktb.mma3_tiles(h, w), SMS // chunks)


def test_step_launches_carry_the_stage_items():
    ktb.reset_launches()
    ktb.launches["stage"] = 2
    ktb.stage_items.update(items=200, prefetched=150)
    assert ktb.step_launches() == {"launches": 2, "small_plane_launches": 0,
                                   "stage_items": 200,
                                   "stage_prefetched": 150}
    ktb.reset_launches()
    assert ktb.stage_items == {"items": 0, "prefetched": 0}
    assert ktb.step_launches() == {"launches": 0, "small_plane_launches": 0,
                                   "stage_items": 0, "stage_prefetched": 0}


def test_the_prefetch_metric_reads_the_capture_span(monkeypatch):
    """``ktrain.stage_prefetch_pct``: 100 * prefetched / items from the
    last ``train.capture`` span before the window; None where the span
    lacks the attributes (a program without the counter) and outside a
    train run."""
    tracing = importlib.import_module(f"{harness.PORT}.core.tracing")
    # a ring of its own: spans that earlier tests of this process closed
    # may have overflowed the shared one
    monkeypatch.setattr(tracing, "_ring", deque(maxlen=tracing.RING))
    monkeypatch.setattr(tracing, "_closed", itertools.count(1))
    metric = harness.reader("ktrain.stage_prefetch_pct")

    def window_after_last_span():
        t_open = tracing.spans()[-1].t1 * 1e-9 + 1.0
        return {"kind": "train", "chunks": [(t_open, t_open + 1.0, False)]}

    with tracing.span("train.capture", launches=131,
                      small_plane_launches=59):
        pass
    assert metric.read(window_after_last_span()) is None
    with tracing.span("train.capture", launches=131, stage_items=153376,
                      stage_prefetched=139772):
        pass
    rec = window_after_last_span()
    assert metric.read(rec) == pytest.approx(100 * 139772 / 153376)
    assert metric.read(dict(rec, kind="serve")) is None
