"""PNG-in-AVI video I/O of the port (``data/videoio.py``) against cv2 and
the JAX package's reader: the port's files read bit for bit by cv2 and
by ``sim2real_lane_segment_tpu.data.videoio.read_frames``; cv2's MPNG
files (OpenDML) read bit for bit by the port; frame counts, fps, the
RIFF size guard and the threaded writer."""
import os

import cv2
import numpy as np
import pytest

from sim2real_lane_segment_tpu.data import videoio as jvideo
from sim2real_lane_segment_tpu_torch.data import png
from sim2real_lane_segment_tpu_torch.data import videoio


def frames(n, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    f[:, : h // 2, : w // 2] = (10, 200, 30)   # flat regions deflate
    return f


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


@pytest.mark.parametrize("h,w,fps", [(48, 64, 30.0), (120, 160, 29.97),
                                     (45, 67, 15.0)])
def test_port_files_read_by_cv2_and_jax(tmp_path, h, w, fps):
    f = frames(7, h, w)
    path = str(tmp_path / "sub" / "a.avi")
    with videoio.VideoWriter(path, (w, h), fps=fps) as wr:
        wr.write(f[0])
        wr.write(f[1:])
    np.testing.assert_array_equal(cv2_frames(path), f)
    np.testing.assert_array_equal(
        np.concatenate(list(jvideo.read_frames(path, 3))), f)
    assert jvideo.frame_count(path) == videoio.frame_count(path) == 7
    assert jvideo.fps_of(path) == pytest.approx(fps)
    assert videoio.fps_of(path) == pytest.approx(fps)
    got = list(videoio.read_frames(path, 3))
    assert [len(b) for b in got] == [3, 3, 1]
    np.testing.assert_array_equal(np.concatenate(got), f)


def test_cv2_mpng_files_read_by_port(tmp_path):
    """cv2's MPNG writer (FFmpeg: adaptive row filters, OpenDML headers)."""
    f = frames(5, 40, 56, seed=1)
    path = str(tmp_path / "cv.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MPNG"), 25.0,
                         (56, 40), True)
    assert wr.isOpened()
    for x in f:
        wr.write(x)
    wr.release()
    np.testing.assert_array_equal(
        np.concatenate(list(videoio.read_frames(path, 2))), f)
    assert videoio.frame_count(path) == 5
    assert videoio.fps_of(path) == pytest.approx(25.0)
    a, b = (np.concatenate(x) for x in zip(*videoio.read_paired_frames(
        path, path, 4)))
    np.testing.assert_array_equal(a, f)
    np.testing.assert_array_equal(b, f)


def test_gray_stream_reads_as_bgr(tmp_path):
    g = frames(3)[..., 1]
    path = str(tmp_path / "g.avi")
    with videoio.VideoWriter(path, (64, 48), is_color=False) as wr:
        wr.write(g)
    want = np.repeat(g[..., None], 3, axis=-1)
    np.testing.assert_array_equal(cv2_frames(path), want)
    np.testing.assert_array_equal(next(videoio.read_frames(path)), want)


def test_ffv1_is_refused(tmp_path):
    path = str(tmp_path / "ffv1.avi")
    with jvideo.VideoWriter(path, (64, 48)) as wr:
        wr.write(frames(2))
    with pytest.raises(IOError, match="FFV1"):
        next(videoio.read_frames(path))
    (tmp_path / "text.avi").write_text("not a video")
    with pytest.raises(IOError, match="not an AVI"):
        videoio.probe(str(tmp_path / "text.avi"))


def test_riff_limit_guard(tmp_path, monkeypatch):
    f = frames(4)
    one = len(png.encode_png(f[0][..., ::-1], level=videoio.ZLIB_LEVEL))
    monkeypatch.setattr(videoio, "RIFF_LIMIT", 2000 + 3 * (one + 40))
    path = str(tmp_path / "big.avi")
    wr = videoio.VideoWriter(path, (64, 48))
    wr.write(f[:2])
    with pytest.raises(ValueError, match="RIFF limit"):
        wr.write(f[2:])
    wr.release()
    # what was written before the refusal stays a valid file
    assert 2 <= videoio.frame_count(path) <= 3
    np.testing.assert_array_equal(cv2_frames(path)[:2], f[:2])
    assert os.path.getsize(path) <= videoio.RIFF_LIMIT


def test_async_writer_order_and_errors(tmp_path):
    f = frames(9)
    path = str(tmp_path / "as.avi")
    with videoio.AsyncVideoWriter(path, (64, 48), maxsize=2) as wr:
        for i in range(0, 9, 2):
            wr.write(f[i:i + 2])
    assert wr.seconds > 0
    np.testing.assert_array_equal(next(videoio.read_frames(path, 64)), f)
    bad = videoio.AsyncVideoWriter(str(tmp_path / "bad.avi"), (64, 48))
    bad.write(frames(1, 10, 10))
    with pytest.raises(ValueError, match="expected"):
        bad.close()
