"""The port's data-generation CLIs against the JAX package's, on the CPU:
``cli.datagen`` recordings labelled by the JAX ``postprocess`` and by the
port's (the label videos equal frame for frame), ``preprocess_db`` of
both packages over the same labelled videos (the same PNG pixels in the
same splits), the JAX package's own FFV1 recording (the committed fixture
of ``scripts/make_ffv1_fixture.py``) through the port's ``postprocess``
and the JAX postprocess output through the port's ``preprocess_db``, and
the domain study's render of a missing domain at a small size.
``random`` is seeded before each ``postprocess`` call, whose recording
shuffle is unseeded in both packages."""
import glob
import hashlib
import json
import os
import pathlib
import random
import shutil

import cv2
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu.cli import postprocess as jpost
from sim2real_lane_segment_tpu.cli import preprocess_db as jprep
from sim2real_lane_segment_tpu_torch.cli import datagen, domain_study
from sim2real_lane_segment_tpu_torch.cli import postprocess, preprocess_db
from sim2real_lane_segment_tpu_torch.data import videoio
from sim2real_lane_segment_tpu_torch.data.png import read_png

torch.set_num_threads(2)

H, W = 48, 64
FIXTURE = (pathlib.Path(__file__).resolve().parents[1]
           / "sim2real_lane_segment_tpu_torch" / "data" / "assets" / "ffv1")


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    out = tmp_path_factory.mktemp("rec")
    stats = datagen.run(
        ["--map-name", "loop_dyn_duckiebots", "--episodes", "2", "--steps",
         "6", "--agents", "2", "--chunk", "3", "--distortion", "--height",
         str(H), "--width", str(W), "--output_dir", str(out)], device="cpu")
    assert stats.n_frames == 2 * 6 * 2 and stats.render_seconds > 0
    return out


def cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    return np.stack(out)


def test_recordings_layout(recordings):
    names = sorted(os.listdir(recordings))
    assert names == [f"{i:03d}_{k}.avi" for i in range(4)
                     for k in ("annot", "orig")]
    for n in names:
        path = str(recordings / n)
        assert videoio.frame_count(path) == 6
        assert videoio.codec_of(path) == "FFV1"
        f = cv2_frames(path)
        assert f.shape == (6, H, W, 3)
        np.testing.assert_array_equal(
            np.concatenate(list(videoio.read_frames(path))), f)


def test_labels_match_jax_postprocess(recordings, tmp_path):
    random.seed(3)
    assert jpost.main(["-id", str(recordings), "-od",
                       str(tmp_path / "jax")]) == 4
    random.seed(3)
    assert postprocess.main(["-id", str(recordings), "-od",
                             str(tmp_path / "port"), "--batch_size", "4"],
                            device="cpu") == 4
    classes = set()
    for kind in ("input", "label"):
        for i in range(4):
            name = f"{i:06d}.avi"
            ref = cv2_frames(str(tmp_path / "jax" / kind / name))
            got = np.concatenate(list(videoio.read_frames(
                str(tmp_path / "port" / kind / name))))
            np.testing.assert_array_equal(got, ref)
            if kind == "label":
                classes |= set(np.unique(got).tolist())
    assert {0, 1, 2} <= classes <= {0, 1, 2, 3}


@pytest.mark.parametrize("extra", [[], ["--grayscale", "--resize", "--width",
                                        "40", "--height", "30"]])
def test_preprocess_db_matches_jax(recordings, tmp_path, extra):
    random.seed(5)
    postprocess.main(["-id", str(recordings), "-od", str(tmp_path / "a")],
                     device="cpu")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    jprep.main(["--dbType", "sim", "--dataPath", str(tmp_path / "a"),
                *extra])
    preprocess_db.main(["--dbType", "sim", "--dataPath", str(tmp_path / "b"),
                        *extra], device="cpu")
    assert same_trees(tmp_path / "a", tmp_path / "b") == [17, 3, 4]
    assert not os.path.exists(tmp_path / "b" / "input")


def same_trees(ref_root, port_root) -> list:
    """Asserts equal file names and PNG pixels in the train/valid/test
    splits of two ``preprocess_db`` trees; returns the split sizes."""
    split_sizes = []
    for split in ("train", "valid", "test"):
        for kind in ("input", "label"):
            a = sorted(glob.glob(str(ref_root / split / kind / "*")))
            b = sorted(glob.glob(str(port_root / split / kind / "*")))
            assert [os.path.basename(p) for p in a] == [
                os.path.basename(p) for p in b]
            for pa, pb in zip(a, b):
                ref = cv2.imread(pa, cv2.IMREAD_UNCHANGED)
                got = read_png(pb, color=ref.ndim == 3)
                np.testing.assert_array_equal(got, ref)
        split_sizes.append(len(a))
    return split_sizes


@pytest.fixture
def jax_recording(tmp_path):
    """The JAX package's datagen recording (FFV1, 16 frames at 160x120)."""
    rec = tmp_path / "jax_rec"
    rec.mkdir()
    for name in ("000_orig.avi", "000_annot.avi"):
        shutil.copyfile(FIXTURE / name, rec / name)
    return rec


def test_jax_recordings_through_port_postprocess(jax_recording, tmp_path):
    """The port's postprocess labels the JAX package's recording into the
    input and label videos the JAX postprocess writes, frame for frame
    (and to the committed digests of them)."""
    assert postprocess.main(["-id", str(jax_recording), "-od",
                             str(tmp_path / "port"), "--batch_size", "6"],
                            device="cpu") == 1
    random.seed(1)
    assert jpost.main(["-id", str(jax_recording), "-od",
                       str(tmp_path / "jax")]) == 1
    want = json.loads((FIXTURE / "digests.json").read_text())["postprocess"]
    for kind in ("input", "label"):
        path = str(tmp_path / "port" / kind / "000000.avi")
        assert videoio.codec_of(path) == "FFV1"
        got = np.concatenate(list(videoio.read_frames(path)))
        np.testing.assert_array_equal(
            got, cv2_frames(str(tmp_path / "jax" / kind / "000000.avi")))
        assert [hashlib.sha256(f.tobytes()).hexdigest()
                for f in got] == want[kind]


def test_jax_postprocess_output_through_port_preprocess_db(jax_recording,
                                                           tmp_path):
    """The JAX postprocess output (cv2's FFV1) split by the port's
    preprocess_db into the JAX preprocess_db's PNG tree."""
    random.seed(2)
    jpost.main(["-id", str(jax_recording), "-od", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    jprep.main(["--dbType", "sim", "--dataPath", str(tmp_path / "a")])
    preprocess_db.main(["--dbType", "sim", "--dataPath", str(tmp_path / "b")],
                       device="cpu")
    assert sum(same_trees(tmp_path / "a", tmp_path / "b")) == 16


def test_record_domain_tiny(tmp_path, monkeypatch):
    """A missing domain renders (1 episode of 24 steps at 64x48), is
    labelled and split; the colour shift and the sensor noise are the
    JAX study's arithmetic and numpy draws over the same frames."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(domain_study, "RECORD_SIZE", (W, H))
    kw = dict(seed=9, episodes=1, steps=24, distortion=True, device="cpu")
    domain_study._record_domain("plain", "zigzag", **kw)
    domain_study._record_domain("shifted", "zigzag", **kw,
                                color_shift=((1.05, 0.85, 0.7), -12),
                                noise_sigma=3.0)
    domain_study._record_domain("shifted", "zigzag", **kw)   # cached
    rng = np.random.default_rng(9 + 77)
    counts = []
    for split in ("train", "valid", "test"):
        inputs = sorted(glob.glob(f"plain/{split}/input/*.png"))
        counts.append(len(inputs))
        for p in inputs:
            img = cv2.imread(p).astype(np.float32)
            img = img * np.asarray((1.05, 0.85, 0.7)) - 12
            img = img + rng.normal(0.0, 3.0, img.shape)
            want = np.clip(img, 0, 255).astype(np.uint8)
            np.testing.assert_array_equal(
                read_png(p.replace("plain", "shifted")), want)
            lab = read_png(p.replace("input", "label"), color=False)
            np.testing.assert_array_equal(
                lab, read_png(p.replace("plain", "shifted").replace(
                    "input", "label"), color=False))
            assert lab.max() <= 3
    assert counts == [17, 3, 4]
    assert not os.path.exists("plain_raw") and os.path.isdir("plain_rec")
    recorded = glob.glob("plain_rec/*.avi")
    assert recorded and {videoio.codec_of(p) for p in recorded} == {"FFV1"}


def test_clis_need_a_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "d" / "input").mkdir(parents=True)
    (tmp_path / "d" / "label").mkdir()
    calls = [(datagen.main, ["--output_dir", str(tmp_path / "r")]),
             (postprocess.main, ["-id", str(tmp_path), "-od",
                                 str(tmp_path / "o")]),
             (preprocess_db.main, ["--dbType", "sim", "--dataPath",
                                   str(tmp_path / "d")])]
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
