"""The port's real-domain ingestion (``cli/create_real_db.py``,
``ops/raster.py``, ``cli/get_real_data.py``) and ``cli/plot_lr.py``
against the JAX package's, on the CPU.

- ``shapes_to_label`` byte-equal to the JAX function (cv2's fillPoly,
  rectangle and circle) on the committed labelme fixtures and on seeded
  shapes: convex, concave and self-intersecting polygons, horizontal
  edges, rectangles with their corners in any order, circles down to
  radius 0, shapes clipped at the border, overlapping shapes painted in
  file order with unknown labels and unsupported types skipped.
- The fixture path ``create_real_db -> preprocess_db --dbType real ->`` one
  MME step on a synthetic source plus the real target, as
  ``tests/test_real_ingestion.py`` holds it for JAX; the label PNGs equal
  the JAX CLI's.
- ``create_real_db --imitate`` writes nothing; ``get_real_data
  --imitate`` makes no network call; a failed download is skipped;
  ``--explode`` writes a PNG-in-AVI's frames and raises naming the codec
  of any other video.
- ``plot_lr``'s schedules equal the JAX CLI's values; its plot equals the
  JAX CLI's where matplotlib is installed.
"""
import glob
import json
import math
import os
import shutil
import struct
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from helpers import write_split

from sim2real_lane_segment_tpu.cli import create_real_db as jax_crdb
from sim2real_lane_segment_tpu.cli import plot_lr as jax_plot_lr
from sim2real_lane_segment_tpu.train.schedules import \
    cosine_annealing as jax_cosine
from sim2real_lane_segment_tpu_torch.cli import create_real_db as crdb
from sim2real_lane_segment_tpu_torch.cli import get_real_data as grd
from sim2real_lane_segment_tpu_torch.cli import plot_lr
from sim2real_lane_segment_tpu_torch.cli import preprocess_db
from sim2real_lane_segment_tpu_torch.cli.test import build_model
from sim2real_lane_segment_tpu_torch.data import videoio
from sim2real_lane_segment_tpu_torch.data.modules import \
    TwoDomainMMEDataModule
from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "labelme_frames")
MAP = jax_crdb.LABEL_NAME_TO_VALUE
LABELS = ["right", "left", "obstacle"]


def _both(shape_hw, shapes):
    want = jax_crdb.shapes_to_label(shape_hw, shapes, MAP)
    got = crdb.shapes_to_label(shape_hw, shapes, MAP, "cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    return want, got.numpy()


def test_port_map_is_the_jax_map():
    assert crdb.LABEL_NAME_TO_VALUE == MAP


def test_shapes_to_label_needs_a_card_unless_cpu():
    """Like every entry point of the port, the painter runs on the card by
    default and raises when there is none; the CPU only when asked for."""
    shapes = [{"label": "left", "points": [[1, 1], [6, 2], [3, 7]],
               "shape_type": "polygon"}]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crdb.shapes_to_label((8, 8), shapes, MAP)
    got = crdb.shapes_to_label((8, 8), shapes, MAP, device="cpu")
    assert got.device.type == "cpu" and int(got.max()) == MAP["left"]


@pytest.mark.parametrize("stem", ["frame_000", "frame_001", "frame_002"])
def test_fixtures_byte_equal(stem):
    with open(os.path.join(FIXTURES, stem + ".json")) as f:
        shapes = json.load(f)["shapes"]
    img = cv2.imread(os.path.join(FIXTURES, stem + ".png"), cv2.IMREAD_COLOR)
    want, got = _both(img.shape, shapes)
    assert np.array_equal(got, want)
    assert len(np.unique(want)) > 1


# -- seeded shapes -----------------------------------------------------------

def _pts(a) -> list:
    """Vertices with fractions, halves among them (rounded half to even)."""
    return [[float(x), float(y)] for x, y in np.asarray(a)]


def _fractional(rng, n, lo, hi):
    v = rng.integers(lo, hi, (n, 2)) + rng.choice([0.0, 0.25, 0.5, 0.75],
                                                  (n, 2))
    return v


def _convex(rng, h, w):
    n = int(rng.integers(3, 10))
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    c = rng.uniform([0, 0], [w, h])
    r = rng.uniform(2, max(h, w) / 2)
    return [{"label": str(rng.choice(LABELS)), "shape_type": "polygon",
             "points": _pts(np.stack([c[0] + r * np.cos(ang),
                                      c[1] + r * np.sin(ang)], 1))}]


def _concave(rng, h, w):
    n = 2 * int(rng.integers(3, 7))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rad = np.where(np.arange(n) % 2 == 0, rng.uniform(8, 20),
                   rng.uniform(2, 7))
    c = rng.uniform([0, 0], [w, h])
    return [{"label": str(rng.choice(LABELS)), "shape_type": "polygon",
             "points": _pts(np.stack([c[0] + rad * np.cos(ang),
                                      c[1] + rad * np.sin(ang)], 1))}]


def _self_intersecting(rng, h, w):
    return [{"label": str(rng.choice(LABELS)), "shape_type": "polygon",
             "points": _pts(_fractional(rng, int(rng.integers(4, 10)),
                                        0, max(h, w)))}]


def _horizontal_edges(rng, h, w):
    n = int(rng.integers(3, 7))
    xs = np.sort(rng.integers(0, w, n)).astype(float)
    ys = rng.integers(0, h, n).astype(float)
    steps = []
    for x, y in zip(xs, ys):  # a staircase of horizontal runs
        steps += [[x, y], [x + rng.integers(1, 8), y]]
    steps.append([xs[0], float(h - 1)])
    return [{"label": str(rng.choice(LABELS)), "points": steps}]


def _rectangles(rng, h, w):
    out = []
    for _ in range(int(rng.integers(1, 4))):
        p, q = _fractional(rng, 2, -3, max(h, w))
        corners = [[p[0], p[1]], [q[0], q[1]]]
        if rng.random() < 0.5:
            corners = corners[::-1]
        if rng.random() < 0.5:  # the other diagonal
            corners = [[corners[0][0], corners[1][1]],
                       [corners[1][0], corners[0][1]]]
        out.append({"label": str(rng.choice(LABELS)),
                    "shape_type": "rectangle", "points": corners})
    return out


def _circles(rng, h, w):
    out = []
    for _ in range(int(rng.integers(1, 4))):
        c = _fractional(rng, 1, 0, max(h, w))[0]
        r = rng.choice([0.0, 0.3, 0.5, rng.uniform(0, 30)])
        a = rng.uniform(0, 2 * np.pi)
        out.append({"label": str(rng.choice(LABELS)), "shape_type": "circle",
                    "points": [[c[0], c[1]], [c[0] + r * np.cos(a),
                                              c[1] + r * np.sin(a)]]})
    return out


def _clipped(rng, h, w):
    pick = rng.integers(0, 3)
    if pick == 0:
        return [{"label": str(rng.choice(LABELS)),
                 "points": _pts(_fractional(rng, int(rng.integers(3, 9)),
                                            -25, max(h, w) + 25))}]
    if pick == 1:
        p, q = _fractional(rng, 2, -25, max(h, w) + 25)
        return [{"label": "left", "shape_type": "rectangle",
                 "points": [list(p), list(q)]}]
    c = _fractional(rng, 1, -10, max(h, w) + 10)[0]
    r = rng.uniform(5, 40)
    return [{"label": "obstacle", "shape_type": "circle",
             "points": [list(c), [c[0] + r, c[1]]]}]


def _layered(rng, h, w):
    shapes = (_convex(rng, h, w) + _rectangles(rng, h, w)
              + _circles(rng, h, w) + _self_intersecting(rng, h, w))
    shapes.insert(1, {"label": "sky", "points": [[0, 0], [w, 0], [w, h]]})
    shapes.insert(2, {"label": "right", "shape_type": "line",
                      "points": [[0, 0], [w, h]]})
    shapes.insert(3, {"label": "left", "points": [[0, 0], [w, h]]})
    return shapes


KINDS = {"convex": _convex, "concave": _concave,
         "self_intersecting": _self_intersecting,
         "horizontal_edges": _horizontal_edges, "rectangles": _rectangles,
         "circles": _circles, "clipped": _clipped, "layered": _layered}


@pytest.mark.parametrize("kind", list(KINDS))
def test_seeded_shapes_byte_equal(kind):
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    bad = []
    for i in range(150):
        h, w = int(rng.integers(8, 72)), int(rng.integers(8, 96))
        shapes = KINDS[kind](rng, h, w)
        want, got = _both((h, w, 3), shapes)
        if not np.array_equal(got, want):
            bad.append((i, h, w, shapes, int((got != want).sum())))
    assert not bad, bad[:3]


# -- the fixture path ----------------------------------------------------------

def test_fixture_path_to_one_mme_step(tmp_path):
    real = str(tmp_path / "realData")
    res = crdb.main(["--imgPath", FIXTURES, "--targetPath", real],
                    device="cpu")
    assert res == {"labelled": 3, "unlabelled": 3}
    jax_real = str(tmp_path / "jaxRealData")
    jax_crdb.main(["--imgPath", FIXTURES, "--targetPath", jax_real])
    for sub in ("input", "label", "unlabelled"):
        names = sorted(os.listdir(os.path.join(real, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_real, sub)))
        for n in names:
            flag = (cv2.IMREAD_GRAYSCALE if sub == "label"
                    else cv2.IMREAD_COLOR)
            a = cv2.imread(os.path.join(real, sub, n), flag)
            b = cv2.imread(os.path.join(jax_real, sub, n), flag)
            assert np.array_equal(a, b), (sub, n)
    label = cv2.imread(os.path.join(real, "label", "000000.png"),
                       cv2.IMREAD_GRAYSCALE)
    assert set(np.unique(label)) == {0, 1, 2, 3}
    assert label[35, 10] == 1 and label[24, 10] == 2
    assert label[12, 50] == 3 and label[5, 5] == 0

    preprocess_db.main(["--dbType", "real", "--dataPath", real,
                        "--train_ratio", "0.67"], device="cpu")
    assert len(os.listdir(os.path.join(real, "train", "input"))) == 2
    assert len(os.listdir(os.path.join(real, "test", "input"))) == 1
    assert len(os.listdir(os.path.join(real, "unlabelled", "input"))) == 3

    root = str(tmp_path / "simRealData")
    write_split(os.path.join(root, "source"), 1, np.random.default_rng(0),
                h=48, w=64)
    shutil.copytree(real, os.path.join(root, "target"))
    dm = TwoDomainMMEDataModule(root, batch_size=2)
    dm.setup()
    batch = next(iter(dm.train_batches(0)))
    (x, y), xu = batch
    assert x.shape == (2, 48, 64, 3) and y.shape == (2, 48, 64)
    assert xu.shape == (2, 48, 64, 3)
    torch.manual_seed(0)
    tr = MMETrainer(num_cls=4, height=24, width=32, augment=False,
                    model=build_model("tiny", 4), device="cpu")
    logs = tr.default_step_fn(batch, torch.Generator().manual_seed(1), 0)
    assert math.isfinite(float(logs["tr_loss"]))
    assert math.isfinite(float(logs["tr_loss_adent"]))


def test_create_real_db_imitate_writes_nothing(tmp_path):
    out = str(tmp_path / "realData")
    res = crdb.main(["--imgPath", FIXTURES, "--targetPath", out,
                     "--imitate"], device="cpu")
    assert res == {"labelled": 3, "unlabelled": 3}
    assert not os.path.exists(out)


# -- get_real_data -------------------------------------------------------------

@pytest.fixture
def no_network(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError(f"a network call: {a}")
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_get_real_data_imitate_makes_no_call(tmp_path, monkeypatch,
                                             no_network):
    monkeypatch.chdir(tmp_path)
    res = grd.main(["--imitate"])
    assert res == {"videos": 0, "frames": 0, "urls": 78}
    assert os.listdir(tmp_path) == []
    with open(grd.DEFAULT_URL_FILE) as f:
        assert sum(1 for u in f if u.strip()) == 78


def test_get_real_data_url_file_must_exist(tmp_path, no_network):
    with pytest.raises(SystemExit):
        grd.main(["--urlFile", str(tmp_path / "missing.txt"), "--imitate"])


def test_a_failed_download_is_skipped(tmp_path, monkeypatch):
    calls = []

    def fail(url, fname):
        calls.append(url)
        raise OSError("no route to host")
    monkeypatch.setattr(urllib.request, "urlretrieve", fail)
    urls = tmp_path / "urls.txt"
    urls.write_text("http://videos.invalid/a.mp4\nhttp://videos.invalid/b.mp4\n")
    res = grd.main(["--urlFile", str(urls), "--outputPath",
                    str(tmp_path / "v"), "--framesPath", str(tmp_path / "f"),
                    "--explode"])
    assert res == {"videos": 0, "frames": 0}
    assert len(calls) == 2


def _write_avi(path, frames):
    with videoio.VideoWriter(path, frames.shape[2:0:-1], 30.0) as wr:
        wr.write(frames)


def test_explode_writes_the_frames_of_a_png_avi(tmp_path, no_network):
    frames = np.random.default_rng(1).integers(0, 255, (3, 12, 16, 3),
                                               dtype=np.uint8)
    vids = tmp_path / "v"
    vids.mkdir()
    _write_avi(str(vids / "drive.avi"), frames)
    empty = tmp_path / "urls.txt"
    empty.write_text("")
    res = grd.main(["--urlFile", str(empty), "--outputPath", str(vids),
                    "--framesPath", str(tmp_path / "f"), "--explode"])
    assert res == {"videos": 1, "frames": 3}
    out = sorted(glob.glob(str(tmp_path / "f" / "*.png")))
    assert [os.path.basename(p) for p in out] == [
        "000000.png", "000001.png", "000002.png"]
    for p, f in zip(out, frames):
        assert np.array_equal(cv2.imread(p, cv2.IMREAD_COLOR), f)


def _fake_mp4(path, entry=b"avc1"):
    def box(kind, body):
        return struct.pack(">I", 8 + len(body)) + kind + body
    stsd = box(b"stsd", b"\0\0\0\0" + struct.pack(">I", 1)
               + box(entry, b"\0" * 78))
    moov = box(b"moov", box(b"trak", box(b"mdia", box(b"minf", box(
        b"stbl", stsd)))))
    with open(path, "wb") as f:
        f.write(box(b"ftyp", b"isom\0\0\0\0isomavc1") + box(b"mdat", b"\0" * 64)
                + moov)


def test_explode_names_another_codec(tmp_path):
    mp4 = str(tmp_path / "drive.video.mp4")
    _fake_mp4(mp4)
    with pytest.raises(IOError, match=r"H\.264 \(avc1\)"):
        grd.explode(mp4, str(tmp_path), 0)
    _fake_mp4(mp4, b"hvc1")
    with pytest.raises(IOError, match=r"H\.265"):
        grd.explode(mp4, str(tmp_path), 0)
    avi = str(tmp_path / "ffv1.avi")
    _write_avi(avi, np.zeros((1, 8, 8, 3), np.uint8))
    with open(avi, "rb") as f:
        data = f.read()
    with open(avi, "wb") as f:  # the stream's codec, as cv2 writes FFV1
        f.write(data.replace(b"MPNG", b"FFV1"))
    with pytest.raises(IOError, match="FFV1"):
        grd.explode(avi, str(tmp_path), 0)
    assert not glob.glob(str(tmp_path / "*.png"))


# -- plot_lr -------------------------------------------------------------------

@pytest.mark.parametrize("lr0,ratio,epochs", [(1e-3, 1000, 175),
                                              (3e-4, 10, 60)])
def test_plot_lr_values_equal_jax(lr0, ratio, epochs):
    got = plot_lr.schedules(lr0, ratio, epochs)
    e = range(epochs)
    assert got["adamw"] == [jax_cosine(lr0, lr0 / ratio, 25, i) for i in e]
    assert got["sgd_fe"] == [jax_cosine(lr0 / 3, lr0 * 1e-3, 25, i)
                             for i in e]
    assert got["sgd_cls"] == [jax_cosine(lr0, lr0 * 1e-3, 25, i) for i in e]


def test_plot_lr_png_equals_jax(tmp_path):
    pytest.importorskip("matplotlib")
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert plot_lr.main(["--out", ours, "--epochs", "60"]) == ours
    jax_plot_lr.main(["--out", theirs, "--epochs", "60"])
    a = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    b = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
    assert a is not None and a.shape == b.shape
    assert np.array_equal(a, b)
