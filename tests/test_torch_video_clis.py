"""The port's video CLIs (``make_demo_video``, ``comparison``) and its
RGBA PNGs against the JAX package and cv2, on the CPU.

- ``predict_video`` against JAX's on one PNG-in-AVI input, the ``tiny``
  FC-DenseNet in float32 with JAX's weights: the JAX output (FFV1) read
  back with cv2, the port's (MPNG) with the port's reader; PIXEL_EQUAL of
  the pixels equal.  The fused route (the K4 kernels' plain versions on
  the CPU) against the plain one, to the same bound.
- ``comparison``: the header byte for byte equal to ``cv2.putText``'s;
  the montage against JAX's for the same ``random.sample`` draw (the
  models cut to ``tiny`` in both packages): the header rows equal and
  PIXEL_EQUAL of the pixels equal.
- RGBA PNGs: what the port writes cv2 reads back unchanged, and the
  reverse, byte for byte.
"""
import glob
import os
import random

import cv2
import jax
import numpy as np
import pytest
import torch
from flax import serialization

from helpers import tiny_model, write_split
from sim2real_lane_segment_tpu.cli import comparison as jcomparison
from sim2real_lane_segment_tpu.cli import make_demo_video as jdemo
from sim2real_lane_segment_tpu.models import tiramisu as jtiramisu
from sim2real_lane_segment_tpu.train.supervised import \
    SupervisedTrainer as JaxTrainer
from sim2real_lane_segment_tpu.train.supervised import TrainState

from test_torch_common import jax_variables, load_port, unflatten
from sim2real_lane_segment_tpu_torch.cli import comparison, make_demo_video
from sim2real_lane_segment_tpu_torch.cli import test as tcli
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.data import png, videoio
from sim2real_lane_segment_tpu_torch.train.supervised import \
    SupervisedTrainer

torch.set_num_threads(2)

PIXEL_EQUAL = 0.999


def cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


def pixels_equal(a, b):
    return (a == b).all(-1).mean()


def input_video(path, n=10, h=48, w=64):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.stack([np.clip(((yy * (3 + i) + xx * 5) % 256)[..., None]
                               + rng.integers(0, 60, (h, w, 3)), 0, 255)
                       for i in range(n)]).astype(np.uint8)
    with videoio.VideoWriter(path, (w, h), fps=15.0) as wr:
        wr.write(frames)
    return frames


@pytest.fixture(scope="module")
def tiny_weights():
    return jax_variables(tiny_model(), (1, 120, 160, 3), seed=3)


def test_predict_video_matches_jax(tmp_path, tiny_weights):
    src = str(tmp_path / "in.avi")
    input_video(src)
    jt = JaxTrainer(num_cls=4, model=tiny_model())
    v = unflatten(tiny_weights)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=None)
    jout = str(tmp_path / "jax.avi")
    assert jdemo.predict_video(src, jout, jt, state, batch_size=4) == 10
    trainer = SupervisedTrainer(
        num_cls=4, device="cpu",
        model=load_port(tcli.build_model("tiny", 4, F32_POLICY),
                        tiny_weights))
    outs = {}
    for fused in (False, True):
        path = str(tmp_path / f"port{int(fused)}.avi")
        st = make_demo_video.predict_video(
            src, path, trainer, batch_size=4,
            predict=trainer.predict_step_fused if fused else None)
        assert st["frames"] == 10 and st["seconds"] > 0
        outs[fused] = np.concatenate(list(videoio.read_frames(path)))
        np.testing.assert_array_equal(cv2_frames(path), outs[fused])
        assert videoio.fps_of(path) == pytest.approx(15.0)
    ref = cv2_frames(jout)
    assert ref.shape == outs[False].shape == (10, 120, 160, 3)
    assert pixels_equal(outs[False], ref) >= PIXEL_EQUAL
    assert pixels_equal(outs[True], outs[False]) >= PIXEL_EQUAL
    assert (outs[False] != cv2.resize(cv2_frames(src)[0], (160, 120),
                                      interpolation=cv2.INTER_LANCZOS4)
            ).any()   # classes painted in


def test_make_demo_video_main(tmp_path, tiny_weights, monkeypatch):
    monkeypatch.chdir(tmp_path)
    input_video("a.avi", n=5)
    input_video("b.avi", n=3)
    model = load_port(tcli.build_model("tiny", 4, F32_POLICY), tiny_weights)
    torch.save(model.state_dict(), "w.pt")
    n = make_demo_video.main(["-t", "MME", "--checkpointPath", "w.pt",
                              "--arch", "tiny", "--fused", "-b", "2",
                              "--videoIns", "a.avi", "b.avi", "--videoOuts",
                              "oa.avi", "ob.avi"], device="cpu")
    assert n["frames"] == 8 and videoio.frame_count("ob.avi") == 3
    with pytest.raises(SystemExit):
        make_demo_video.main(["-t", "baseline", "--checkpointPath", "w.pt",
                              "--videoIns", "a.avi", "b.avi"], device="cpu")
    v = unflatten(tiny_weights)
    jdemo.predict_video("a.avi", "ffv1.avi", JaxTrainer(
        num_cls=4, model=tiny_model()), TrainState(
            params=v["params"], batch_stats=v["batch_stats"],
            opt_state=None))
    with pytest.raises(IOError, match="FFV1"):   # the JAX CLI's output
        make_demo_video.main(["-t", "baseline", "--checkpointPath", "w.pt",
                              "--arch", "tiny", "--videoIns", "ffv1.avi",
                              "--videoOuts", "o.avi"], device="cpu")


def cv2_header():
    header = np.zeros((24, 960, 4), np.uint8)
    for i, name in enumerate(comparison.COLS):
        header = cv2.putText(header, name, (i * 160 + 20, 21),
                             cv2.FONT_HERSHEY_SIMPLEX, 0.75, (0, 0, 0, 255))
    return header


def test_comparison_header_is_cv2s():
    assert comparison.COLS == jcomparison.COLS
    np.testing.assert_array_equal(comparison.header(), cv2_header())


def test_comparison_montage_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_split("real", 6, np.random.default_rng(1), h=60, w=80,
                with_labels=False)
    data = os.path.join("real", "input")
    paths = []
    for i in range(5):
        v = unflatten(jax_variables(tiny_model(2), (1, 120, 160, 3),
                                    seed=10 + i))
        paths.append(f"w{i}.msgpack")
        with open(paths[-1], "wb") as f:
            f.write(serialization.to_bytes(jax.device_get(
                {"params": v["params"], "batch_stats": v["batch_stats"]})))
    monkeypatch.setattr(jtiramisu, "fcdensenet57",
                        lambda n, policy=None: tiny_model(n))
    real_build = tcli.build_model
    monkeypatch.setattr(tcli, "build_model", lambda arch, n, policy=None:
                        real_build("tiny", n, F32_POLICY))
    argv = ["--dataPath", data, "--showCount", "3"]
    for flag, p in zip(("--baselinePath", "--sandtPath", "--hmPath",
                        "--cycleganPath", "--mmePath"), paths):
        argv += [flag, p]
    random.seed(5)
    jcomparison.main(argv + ["--resultPath", "jax/c.png"])
    random.seed(5)
    out = comparison.main(argv + ["--resultPath", "port/c.png"],
                          device="cpu")
    got = cv2.imread(out, cv2.IMREAD_UNCHANGED)
    ref = cv2.imread("jax/c.png", cv2.IMREAD_UNCHANGED)
    assert got.shape == ref.shape == (24 + 3 * 120, 960, 4)
    np.testing.assert_array_equal(got[:24], ref[:24])
    assert pixels_equal(got, ref) >= PIXEL_EQUAL
    assert (got[24:, 160:, 2] == 255).any()   # predictions painted red
    assert len(glob.glob(os.path.join(data, "*.png"))) == 6


def test_rgba_png_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (23, 37, 4), dtype=np.uint8)
    img[:10, :10] = (1, 2, 3, 255)
    ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    for f in range(5):
        png.write_png(ours, img, filter_type=f)
        np.testing.assert_array_equal(
            cv2.imread(ours, cv2.IMREAD_UNCHANGED), img)
    cv2.imwrite(theirs, img)
    np.testing.assert_array_equal(png.read_png(theirs, color=None), img)
    np.testing.assert_array_equal(png.read_png(theirs),
                                  cv2.imread(theirs, cv2.IMREAD_COLOR))
    bgr = img[..., :3].copy()
    png.write_png(ours, bgr)
    np.testing.assert_array_equal(png.read_png(ours, color=None), bgr)
