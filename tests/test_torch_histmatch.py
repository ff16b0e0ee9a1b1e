"""Histogram matching: the port (``ops.histmatch``, ``cli.hist_match``)
against the JAX package on the CPU.

The tables are built with the JAX function's own float32 arithmetic (the
constant division as XLA's reciprocal product, its fused multiply-adds
rounded once), so the gate is bit-equality: no pixel may differ.
"""
import os
import random

import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu.ops.histmatch import \
    match_histograms_batch as jax_match
from sim2real_lane_segment_tpu_torch.data.png import read_png, write_png
from sim2real_lane_segment_tpu_torch.ops.histmatch import (
    match_histograms, match_histograms_batch)

torch.set_num_threads(2)


def _case(name, rng):
    """(sources, references) uint8 batches; the two sizes differ."""
    if name == "uniform_vs_skewed":
        src = rng.integers(0, 256, (3, 60, 80, 3), dtype=np.uint8)
        ref = (rng.integers(0, 128, (3, 50, 70, 3)) ** 2 // 64).astype(
            np.uint8)
    elif name == "skewed_vs_uniform":
        src = (rng.integers(0, 16, (2, 48, 64, 3)) ** 2).astype(np.uint8)
        ref = rng.integers(30, 200, (2, 33, 41, 3), dtype=np.uint8)
    elif name == "sparse_template":
        src = rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
        ref = rng.choice(np.array([3, 17, 120, 200, 255], np.uint8),
                         (2, 30, 30, 3))
    elif name == "constant_template":
        src = rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
        ref = np.full((2, 30, 30, 3), 77, np.uint8)
    else:  # identity
        src = rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
        ref = src
    return src, ref


@pytest.mark.parametrize("name", ["uniform_vs_skewed", "skewed_vs_uniform",
                                  "sparse_template", "constant_template",
                                  "identity"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_equal_to_jax(name, seed):
    src, ref = _case(name, np.random.default_rng(seed))
    want = np.asarray(jax_match(src, ref))
    got = match_histograms_batch(torch.from_numpy(src),
                                 torch.from_numpy(ref)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if name == "identity":
        np.testing.assert_array_equal(got, src)


def test_single_image_form(rng):
    src, ref = _case("uniform_vs_skewed", rng)
    one = match_histograms(torch.from_numpy(src[1]), torch.from_numpy(ref[1]))
    np.testing.assert_array_equal(
        one.numpy(), match_histograms_batch(torch.from_numpy(src),
                                            torch.from_numpy(ref))[1].numpy())


def _tree(root, n, seed, skew):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "input"))
    for i in range(n):
        img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        if skew:
            img = (img.astype(np.uint16) ** 2 // 256).astype(np.uint8)
        write_png(os.path.join(root, "input", f"{i:06d}.png"), img)


def _frames(root):
    d = os.path.join(root, "input")
    return [read_png(os.path.join(d, f)) for f in sorted(os.listdir(d))]


@pytest.mark.parametrize("shuffle", [False, True])
def test_cli_against_jax(tmp_path, shuffle):
    """Both CLIs on copies of one tree (5 sources, 3 references, batches of
    2): the decoded PNGs written back must be equal.  With shuffling both
    draw from ``random`` after the same seed."""
    from sim2real_lane_segment_tpu.cli import hist_match as jax_cli
    from sim2real_lane_segment_tpu_torch.cli import hist_match as port_cli

    roots = {}
    for side in ("jax", "port"):
        _tree(str(tmp_path / side / "src"), 5, 0, skew=False)
        _tree(str(tmp_path / side / "ref"), 3, 1, skew=True)
        roots[side] = tmp_path / side
    before = _frames(str(roots["port"] / "src"))
    argv = lambda root: (["--ds_source", str(root / "src"), "--ds_reference",
                          str(root / "ref"), "--batch_size", "2"]
                         + ([] if shuffle else ["--no_shuffle"]))
    random.seed(7)
    assert jax_cli.main(argv(roots["jax"])) == 5
    random.seed(7)
    assert port_cli.main(argv(roots["port"]), device="cpu") == 5
    got, want = _frames(str(roots["port"] / "src")), _frames(
        str(roots["jax"] / "src"))
    for g, w, b in zip(got, want, before):
        np.testing.assert_array_equal(g, w)
    assert any((g != b).any() for g, b in zip(got, before))
