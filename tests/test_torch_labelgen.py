"""The port's morphology and label extraction (``ops/morphology``,
``ops/labelgen``, the plain version of kernel K5) against the JAX
package's ``process_classes`` and its Pallas kernel in interpret mode, on
the CPU.  Every comparison is bit-exact: the JAX functions are exact
against cv2 (tests/test_morphology.py, tests/test_labelgen.py)."""
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu.ops import labelgen_pallas as LP
from sim2real_lane_segment_tpu.ops import morphology as JM
from sim2real_lane_segment_tpu.ops.labelgen import \
    process_classes as jax_process_classes
from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg
from sim2real_lane_segment_tpu_torch.ops import morphology as PM
from sim2real_lane_segment_tpu_torch.ops.labelgen import (
    process_classes, process_classes_batch)


def pairs(n, h, w, seed):
    """Seeded frame pairs: a lane-like region per rule (each class alone
    and mixed), runs thinner than the 5x5 window, and sparse noise."""
    rng = np.random.default_rng(seed)
    orig = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    delta = np.zeros((n, h, w, 3), np.int64)
    kinds = np.array([(0, 60, 0), (60, 0, 0), (0, 0, 60), (-60, 0, 0),
                      (0, -60, 0), (60, 60, -60), (0, 60, -60)])
    for _ in range(12):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(1, h // 3 + 2), rng.integers(1, w // 3 + 2)
        delta[:, y0:y0 + dy, x0:x0 + dx] += kinds[rng.integers(len(kinds))]
    noise = rng.random(orig.shape) < 0.02
    delta += noise * rng.integers(-30, 31, orig.shape)
    annot = np.clip(orig.astype(np.int64) + delta, 0, 255).astype(np.uint8)
    return orig, annot


@pytest.mark.parametrize("op", ["erode", "dilate", "morph_open",
                                "morph_close"])
@pytest.mark.parametrize("shape", [(2, 17, 23), (1, 4, 3), (30, 40)])
def test_morphology_matches_jax(op, shape):
    """cv2 borders: erosion pads 1, dilation pads 0 (odd sizes, a mask
    smaller than the window, and no leading axis)."""
    rng = np.random.default_rng(sum(shape))
    m = rng.random(shape) < 0.6
    ref = np.asarray(getattr(JM, op)(m, 5))
    out = getattr(PM, op)(torch.from_numpy(m), 5)
    assert out.dtype == torch.bool and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("order", ["bgr", "rgb"])
@pytest.mark.parametrize("h", [240, 100])
def test_process_classes_matches_jax(h, order):
    orig, annot = pairs(2, h, 320, seed=h)
    ref = np.asarray(jax_process_classes(orig, annot, channel_order=order))
    out = process_classes(torch.from_numpy(orig), torch.from_numpy(annot),
                          order)
    assert out.dtype == torch.uint8 and out.shape == (2, h, 320)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) >= 3  # the rules fire, not only background


@pytest.mark.parametrize("order", ["bgr", "rgb"])
@pytest.mark.parametrize("h", [240, 100])
def test_plain_matches_pallas_kernel(h, order):
    """K5's plain version against ``_kernel`` in interpret mode."""
    orig, annot = pairs(1, h, 320, seed=h + 1)
    ref = np.asarray(LP.process_classes_fused(orig, annot,
                                              channel_order=order,
                                              interpret=True))
    out = klg.process_classes_plain(torch.from_numpy(orig),
                                    torch.from_numpy(annot), order)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_numpy_inputs_leading_axes_and_batch_alias():
    orig, annot = pairs(4, 24, 30, seed=5)
    ref = np.asarray(jax_process_classes(orig, annot))
    out = process_classes(orig.reshape(2, 2, 24, 30, 3),
                          annot.reshape(2, 2, 24, 30, 3))
    np.testing.assert_array_equal(out.numpy().reshape(4, 24, 30), ref)
    np.testing.assert_array_equal(process_classes(orig[0], annot[0]).numpy(),
                                  ref[0])
    assert process_classes_batch is process_classes


def test_cpu_tensors_take_the_plain_version():
    orig, annot = pairs(1, 24, 30, seed=6)
    klg.reset_launches()
    process_classes(orig, annot)
    assert klg.launches["labelgen"] == 0


def test_bad_inputs_raise():
    orig, annot = pairs(1, 8, 8, seed=7)
    with pytest.raises(ValueError, match="channel_order"):
        process_classes(orig, annot, "bgra")
    with pytest.raises(ValueError, match="one shape"):
        process_classes(orig, annot[:, :4])
    with pytest.raises(ValueError, match="uint8"):
        process_classes(orig.astype(np.int16), annot.astype(np.int16))


@pytest.mark.parametrize("hw,want", [
    ((480, 640), (15, 20, 1, 20)), ((120, 160), (4, 5, 1, 5)),
    ((1080, 1920), (34, 60, 2, 30)), ((5, 7), (1, 1, 1, 1))])
def test_kernel_geometry(hw, want):
    """K5's launch at the simulator's render size, the model's size, a
    1080p frame (two column tiles) and a frame smaller than the halo:
    (strips, words per row, column tiles, core words)."""
    g = klg.geometry(*hw)
    assert (g.strips, g.words, g.tiles, g.core) == want
    assert g.strip_rows == klg.STRIP_ROWS == 32
    # two buffers of 3 planes x (32 + 2 x 8) rows x 32 words: static
    # shared memory, six blocks to an SM
    assert g.smem == 2 * 3 * 48 * 32 * 4 <= 48 * 1024


@pytest.mark.parametrize("w", [1, 31, 32, 33, 640, 1024, 1025, 1920, 2100,
                               4096, 5000])
def test_kernel_column_tiles_cover_the_row(w):
    """Each word of a row is written by one column tile; a tile stages its
    core words and one halo word (32 pixels, more than the 8 the four
    passes reach) on each inner side, at most one word per lane."""
    g = klg.geometry(7, w)
    assert g.words == -(-w // 32)
    written = []
    for t in range(g.tiles):
        c0, c1 = t * g.core, min(g.words, (t + 1) * g.core)
        lo, hi = max(0, c0 - 1), min(g.words, c1 + 1)
        assert hi - lo <= klg.LANES
        assert (lo < c0) == (t > 0) and (hi > c1) == (t < g.tiles - 1)
        written += range(c0, c1)
    assert written == list(range(g.words))
