"""The port's data path: its PNG codec against cv2, its data module against
the JAX package's on the same tree, and the training CLI end to end on the
CPU (tiny model, two epochs, resume)."""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from helpers import make_sim_tree, write_split

from sim2real_lane_segment_tpu.data.modules import \
    SimulatorDataModule as JaxSimulatorDataModule
from sim2real_lane_segment_tpu_torch.cli import train as train_cli
from sim2real_lane_segment_tpu_torch.cli.test import load_trainer_and_state
from sim2real_lane_segment_tpu_torch.data import png
from sim2real_lane_segment_tpu_torch.data.modules import SimulatorDataModule
from sim2real_lane_segment_tpu_torch.train.checkpoint import load_train_state


def _image(rng, h, w, c):
    """Smooth structure plus noise, so libpng picks several row filters."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 7 + xx * 3) % 256
    img = base[..., None] + rng.integers(0, 40, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8).squeeze()


@pytest.mark.parametrize("channels", [1, 3])
def test_png_reads_cv2_writes(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = _image(rng, 23, 37, channels)
    path = str(tmp_path / "a.png")
    for level in (0, 9):
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        got = png.read_png(path, color=channels == 3)
        np.testing.assert_array_equal(got, img)
    if channels == 1:  # a gray file read as colour: three equal channels
        np.testing.assert_array_equal(png.read_png(path, color=True),
                                      cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_writes_what_cv2_reads(tmp_path, filter_type, channels):
    rng = np.random.default_rng(10 * filter_type + channels)
    img = _image(rng, 9, 14, channels)
    path = str(tmp_path / "b.png")
    png.write_png(path, img, filter_type=filter_type)
    flag = cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE
    np.testing.assert_array_equal(cv2.imread(path, flag), img)
    np.testing.assert_array_equal(png.read_png(path, channels == 3), img)


def test_png_rejects_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))  # 16-bit RGB
    with pytest.raises(ValueError, match="unsupported"):
        png.read_png(path)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


def test_simulator_data_module_matches_jax(tmp_path):
    root = make_sim_tree(tmp_path, np.random.default_rng(3), n_train=7,
                         n_valid=3, n_test=2)
    kw = dict(batch_size=2, seed=5)
    ours, theirs = SimulatorDataModule(root, **kw), \
        JaxSimulatorDataModule(root, **kw)
    ours.setup()
    theirs.setup()
    assert ours.native_size == theirs.native_size
    for epoch in range(2):
        pairs = list(zip(ours.train_batches(epoch),
                         theirs.train_batches(epoch), strict=True))
        assert len(pairs) == 3
        for (x, y), (xr, yr) in pairs:
            np.testing.assert_array_equal(x, xr)
            np.testing.assert_array_equal(y, yr)
    for a, b in zip(ours.val_batches(), theirs.val_batches(), strict=True):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _train_args(root, out, *extra):
    return ["--trainType", "sim", "--dataPath", root, "--arch", "tiny",
            "--max_epochs", "2", "-b", "2", "--height", "24", "--width",
            "32", "--default_root_dir", out, "--log_every", "1", *extra]


def test_train_cli_on_cpu_writes_artifacts_and_resumes(tmp_path):
    rng = np.random.default_rng(4)
    root = str(tmp_path / "simData")
    for split, n in (("train", 4), ("valid", 2), ("test", 2)):
        write_split(os.path.join(root, split), n, rng, h=24, w=32)
    out = str(tmp_path / "runs")
    res = train_cli.main(_train_args(root, out, "--pallas_train"),
                         device="cpu")
    run = res["out_dir"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/tr_loss"] for r in rows if "train/tr_loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert sum("val/iou" in r for r in rows) == 2
    assert any("test/iou" in r for r in rows)
    latest = load_train_state(os.path.join(run, "checkpoints_latest",
                                           "latest.pt"))
    best = load_train_state(os.path.join(run, "checkpoints", "best.pt"))
    assert latest["epoch"] == 1 and best["epoch"] in (0, 1)
    assert best["metrics"]["val_iou"] == res["best_iou"]
    assert set(latest["optimizer"]) == {"count", "mu", "nu"}
    trainer = load_trainer_and_state(
        "baseline", os.path.join(run, "best_weights.pt"), arch="tiny",
        height=24, width=32, device="cpu")
    frames = rng.integers(0, 255, (2, 24, 32, 3), dtype=np.uint8)
    assert trainer.predict_step(frames).shape == (2, 24, 32)

    # resume: the latest channel holds epoch 1, so a 3-epoch run trains
    # epoch 2 only
    res2 = train_cli.main(_train_args(root, out, "--pallas_train",
                                      "--resume") + ["--max_epochs", "3"],
                          device="cpu")
    with open(os.path.join(res2["out_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows if "train/tr_loss" in r]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert load_train_state(os.path.join(
        run, "checkpoints_latest", "latest.pt"))["epoch"] == 2


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    """``--fast_train`` and ``--dp`` are ported: both train in ``sim`` and
    ``st``; what the CLI still refuses is a ``--dp`` rank count the
    launch does not hold."""
    from helpers import make_simreal_tree

    rng = np.random.default_rng(8)
    roots = {"sim": make_sim_tree(tmp_path, rng, 4, 2, 2),
             "st": make_simreal_tree(tmp_path, rng, 4, 2, 8, 2)}
    for extra in (["--fast_train"], ["--dp", "auto"]):
        for regime in ("sim", "st"):
            args = _train_args(roots[regime], str(tmp_path / "o"), *extra)
            args[1] = regime
            res = train_cli.main(args + ["--max_epochs", "1"], device="cpu")
            assert np.isfinite(res["best_iou"])
    with pytest.raises(SystemExit, match="--dp 2"):
        train_cli.main(_train_args(roots["sim"], str(tmp_path / "o"),
                                   "--dp", "2"), device="cpu")


def test_train_cli_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = make_sim_tree(tmp_path, np.random.default_rng(6), 2, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(_train_args(root, str(tmp_path / "o")))
