"""The port's simulator CLIs (``basic_control``, ``sim_benchmark``,
``free_camera``, ``manual_control``, ``train_imitation``,
``train_reinforcement``, ``enjoy``) on the CPU at tiny sizes: each
``main`` with ``device="cpu"``, the fixed 160x120 cameras cut through
the modules' ``CAMERA_HW``.

Against the JAX CLIs: ``basic_control``'s total reward over 32 steps
within TOTAL_REWARD_ATOL (the reward does not read the frame, so both
cameras are cut; per step the poses agree to float32 ulps, see
``test_torch_env``), and ``free_camera --orbit``'s PNGs with
RENDER_EQUAL of their values equal.  The window loops run on scripted
keys; without cv2 the window CLIs exit non-zero and name it.
"""
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu.cli import basic_control as jbasic
from sim2real_lane_segment_tpu.cli import free_camera as jfree
from sim2real_lane_segment_tpu.sim import env as jenv

from sim2real_lane_segment_tpu_torch.cli import (basic_control, enjoy,
                                                 free_camera, manual_control,
                                                 sim_benchmark,
                                                 train_imitation,
                                                 train_reinforcement)
from sim2real_lane_segment_tpu_torch.data import videoio
from sim2real_lane_segment_tpu_torch.data.png import read_png
from sim2real_lane_segment_tpu_torch.sim.env import DuckietownEnv

torch.set_num_threads(2)

TOTAL_REWARD_ATOL = 1e-2
RENDER_EQUAL = 0.9995
TINY = (24, 32)
OBS = ["--obs-height", "30", "--obs-width", "40"]


@pytest.fixture(autouse=True)
def tiny_cameras(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(basic_control, "CAMERA_HW", TINY)
    monkeypatch.setattr(train_reinforcement, "CAMERA_HW", TINY)
    monkeypatch.setattr(enjoy, "CAMERA_HW", TINY)


def test_basic_control_matches_jax(monkeypatch):
    class SmallJaxEnv(jenv.DuckietownEnv):
        def __init__(self, **kw):
            kw.update(camera_width=TINY[1], camera_height=TINY[0])
            super().__init__(**kw)

    monkeypatch.setattr(jenv, "DuckietownEnv", SmallJaxEnv)
    ref = jbasic.main(["--steps", "32"])
    got = basic_control.main(["--steps", "32", "--out", "bc.avi"],
                             device="cpu")
    assert abs(got - ref) < TOTAL_REWARD_ATOL, (got, ref)
    assert videoio.frame_count("bc.avi") == 32
    assert videoio.codec_of("bc.avi") == "FFV1"   # the JAX CLI's format
    assert videoio.probe("bc.avi")[:2] == (TINY[1], TINY[0])


def test_sim_benchmark_prints_its_line(capsys):
    res = sim_benchmark.main(["--width", "32", "--height", "24",
                              "--resets", "2", "--seconds", "0.3",
                              "--batch", "2"], device="cpu")
    assert res["device"] == "cpu"
    for k in ("load_time_ms", "reset_time_ms", "frame_time_ms", "fps",
              "batched_pair_fps"):
        assert res[k] > 0, k
    assert '"batched_pair_fps"' in capsys.readouterr().out


def test_free_camera_orbit_matches_jax():
    argv = ["--orbit", "--frames", "3", "--width", "64", "--height", "48"]
    assert jfree.main(argv + ["--out_dir", "jax"]) == 3
    assert free_camera.main(argv + ["--out_dir", "port"], device="cpu") == 3
    for i in range(3):
        name = f"orbit_{i:03d}.png"
        got = read_png(os.path.join("port", name))
        np.testing.assert_array_equal(got, cv2.imread(
            os.path.join("port", name)))
        assert (got == cv2.imread(os.path.join("jax", name))).mean() \
            >= RENDER_EQUAL


def test_free_camera_keys():
    angles, shown = [], []
    keys = iter([ord("d"), ord("d"), ord("a"), 0, 27])
    n = free_camera.orbit_loop(lambda a: angles.append(a) or a,
                               lambda: next(keys), shown.append)
    assert n == 5 and shown == angles
    np.testing.assert_allclose(angles, [0, 0.1, 0.2, 0.1, 0.1])


@pytest.mark.parametrize("cli,argv", [
    (free_camera, []), (manual_control, [])])
def test_window_clis_need_cv2(monkeypatch, cli, argv):
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    with pytest.raises(SystemExit) as e:
        cli.main(argv, device="cpu")
    assert e.value.code != 0 and "cv2" in str(e.value.code)


def test_manual_control_records_pairs():
    """'a' (annotated mode 1), Enter (record), 3 x 'w', Enter (stop),
    Enter (a second recording), 'w', Esc."""
    env = DuckietownEnv(map_name="small_loop", camera_width=32,
                        camera_height=24, domain_rand=True, device="cpu")
    keys = iter([ord("a"), 13, ord("w"), ord("w"), ord("w"), 13, 13,
                 ord("w"), 27])
    shown = []
    n = manual_control.control_loop(env, lambda: next(keys), shown.append,
                                    "rec")
    assert n == 2 and len(shown) == 8 and env.annotated == 1
    assert sorted(os.listdir("rec")) == ["000_annot.avi", "000_orig.avi",
                                         "001_annot.avi", "001_orig.avi"]
    for seq, frames in (("000", 4), ("001", 2)):
        assert videoio.codec_of(f"rec/{seq}_orig.avi") == "FFV1"
        orig = np.concatenate(list(videoio.read_frames(f"rec/{seq}_orig.avi")))
        annot = np.concatenate(list(videoio.read_frames(
            f"rec/{seq}_annot.avi")))
        assert len(orig) == len(annot) == frames
        assert (orig != annot).any()   # lanes recoloured
    # the last annotated frame is the one shown, in BGR on disk
    np.testing.assert_array_equal(annot[-1], shown[-1][..., ::-1])


def test_train_imitation_then_enjoy():
    res = train_imitation.main(["--episodes", "2", "--steps", "8",
                                "--epochs", "2", "--batch_size", "4",
                                *OBS], device="cpu")
    assert res["frames"] == 16 and len(res["epoch_losses"]) == 2
    assert np.isfinite(res["epoch_losses"]).all()
    out = enjoy.main(["imitation", "--weights", res["out"], "--max-steps",
                      "6", "--out", "enjoy.avi", *OBS], device="cpu")
    assert 1 <= out["steps"] <= 6 and np.isfinite(out["mean_return"])
    assert videoio.frame_count("enjoy.avi") == out["steps"]
    assert videoio.codec_of("enjoy.avi") == "FFV1"


def test_train_reinforcement_then_enjoy():
    res = train_reinforcement.main(["--max_timesteps", "16",
                                    "--start_timesteps", "6",
                                    "--batch_size", "4", "--eval_freq", "8",
                                    *OBS], device="cpu")
    assert len(res["critic_losses"]) == len(res["actor_losses"]) == 10
    assert np.isfinite(res["critic_losses"] + res["actor_losses"]).all()
    assert len(res["evals"]) == 2 and os.path.exists(res["out"])
    out = enjoy.main(["reinforcement", "--weights", res["out"],
                      "--max-steps", "4", *OBS], device="cpu")
    assert 1 <= out["steps"] <= 4


@pytest.mark.parametrize("cli,argv", [
    (basic_control, []), (sim_benchmark, []), (free_camera, ["--orbit"]),
    (manual_control, []), (train_imitation, []), (train_reinforcement, []),
    (enjoy, ["imitation", "--weights", "w.pt"])])
def test_clis_need_a_card_unless_cpu(cli, argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
