"""The port's serving path on the CPU: ``BatchingEngine`` behaviours
(mirroring tests/test_serving.py), the CLI predictor, the fused predict
step against the JAX one on the same ``.npz`` weights, weight files,
LaneNetLite served from the committed student in every mode, and entry
points that must refuse to run without a card."""
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_model
from test_torch_common import jax_variables, unflatten

from sim2real_lane_segment_tpu.train.supervised import \
    SupervisedTrainer as JaxTrainer
from sim2real_lane_segment_tpu_torch.cli import serve as port_serve
from sim2real_lane_segment_tpu_torch.cli.test import (build_model,
                                                      load_trainer_and_state)
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.core.runtime import resolve_device
from sim2real_lane_segment_tpu_torch.serving import (BatchingEngine,
                                                     SegmentationClient,
                                                     _bucket, serve_inference)
from sim2real_lane_segment_tpu_torch.sim.server import recv_array, send_array
from sim2real_lane_segment_tpu_torch.train.checkpoint import (load_weights,
                                                              save_weights)
from sim2real_lane_segment_tpu_torch.train.supervised import SupervisedTrainer

H, W = 24, 32


def rand_frames(n, seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """helpers.tiny_model() weights (perturbed BN) as a flattened-Flax
    .npz, plus the flat dict."""
    flat = jax_variables(tiny_model(), (1, H, W, 3), seed=21)
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    np.savez(path, **flat)
    return path, flat


@pytest.fixture(scope="module")
def trainer(weights):
    return load_trainer_and_state("baseline", weights[0], arch="tiny",
                                  height=H, width=W, device="cpu",
                                  policy=F32_POLICY)


def test_predict_step_fused_matches_jax(weights, trainer):
    """Same .npz weights, same uint8 frames (one batch at the model size,
    one resized from 48x64): equal class maps, float32 on both sides."""
    path, flat = weights
    variables = unflatten(flat)
    jt = JaxTrainer(model=tiny_model(), height=H, width=W, augment=False)
    state = jt.init_state(jax.random.key(0)).replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    for frames in (rand_frames(2, seed=1), rand_frames(2, seed=2, h=48,
                                                       w=64)):
        ref = np.asarray(jt.predict_step_fused(state, frames))
        out = trainer.predict_step_fused(frames)
        assert out.dtype == torch.uint8 and out.shape == (2, H, W)
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(trainer.predict_step(frames).numpy(),
                                      ref)


def test_weights_round_trip(tmp_path, trainer):
    path = str(tmp_path / "sub" / "w.pt")
    save_weights(path, trainer.model)
    model = build_model("tiny", 4, F32_POLICY)
    load_weights(path, model)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="format"):
        load_weights(str(tmp_path / "w.ckpt"), model)


def _args(path, *extra):
    return port_serve.parse_args(["--checkpointPath", path, "--arch", "tiny",
                                  "--height", str(H), "--width", str(W),
                                  *extra])


@pytest.mark.parametrize("fused", [False, True])
def test_cli_predict_fn_returns_host_masks(weights, fused):
    args = _args(weights[0], *(["--fused"] if fused else []))
    predict, h, w = port_serve.build_predict_fn(args, device="cpu")
    assert (h, w) == (H, W)
    masks = predict(rand_frames(3, seed=4))
    assert isinstance(masks, np.ndarray)
    assert masks.dtype == np.uint8 and masks.shape == (3, H, W)
    assert masks.max() < 4


def test_engine_serves_port_predictor(trainer):
    """Concurrent requests through the engine return exactly what the
    predictor gives each request alone (float32, per-image independent)."""
    def predict(frames):
        return trainer.predict_step_fused(frames).numpy()

    eng = BatchingEngine(predict, height=H, width=W, max_batch=8,
                         max_wait_ms=30.0)
    try:
        reqs = [rand_frames(k, seed=10 + k) for k in (1, 3, 2, 1)]
        outs = [None] * len(reqs)

        def one(i):
            outs[i] = eng.predict(reqs[i], timeout=60)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for req, out in zip(reqs, outs):
            np.testing.assert_array_equal(out, predict(req))
        assert eng.stats["frames"] == 7
    finally:
        eng.close()


# -- engine behaviours, as tests/test_serving.py checks the JAX engine -------

def make_engine(calls, **kw):
    def predict(frames):
        calls.append(frames.shape[0])
        return frames[..., 0]

    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 30.0)
    return BatchingEngine(predict, height=H, width=W, **kw)


def test_bucket_sizes():
    assert [_bucket(n, 64) for n in (1, 2, 3, 5, 64, 100)] == \
        [1, 2, 4, 8, 64, 64]


def test_engine_single_batch_and_overflow():
    calls = []
    eng = make_engine(calls, max_batch=4)
    try:
        f = rand_frames(3)
        np.testing.assert_array_equal(eng.predict(f), f[..., 0])
        np.testing.assert_array_equal(eng.predict(f[0])[0], f[0, :, :, 0])
        a, b = eng.submit(rand_frames(3, 2)), eng.submit(rand_frames(3, 3))
        a.wait(10)
        b.wait(10)
        assert all(c in (1, 2, 4) for c in calls)
        assert len(calls) == 4  # 3 + 3 > max_batch: two batches
    finally:
        eng.close()


def test_engine_rejects_bad_shapes():
    eng = make_engine([])
    try:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((1, H + 1, W, 3), np.uint8))
        with pytest.raises(ValueError):
            eng.submit(np.zeros((9, H, W, 3), np.uint8))
    finally:
        eng.close()


def test_engine_requires_host_numpy_results():
    """A predictor that hands back a tensor fails the batch loudly."""
    eng = BatchingEngine(lambda f: torch.from_numpy(f[..., 0]), height=H,
                         width=W, max_batch=4, max_wait_ms=5.0)
    try:
        with pytest.raises(TypeError, match="host numpy"):
            eng.predict(rand_frames(1), timeout=10)
    finally:
        eng.close()


def test_zmq_round_trip_and_array_framing():
    zmq = pytest.importorskip("zmq")
    calls = []
    eng = make_engine(calls)
    res = zmq.Context.instance().socket(zmq.REP)
    port = res.bind_to_random_port("tcp://127.0.0.1")
    res.close(0)
    time.sleep(0.05)
    ready = threading.Event()
    srv = threading.Thread(target=serve_inference, kwargs=dict(
        engine=eng, host="127.0.0.1", port=port, ready=ready, warmup=False),
        daemon=True)
    srv.start()
    assert ready.wait(10)
    cli = SegmentationClient("127.0.0.1", port, timeout_s=30)
    try:
        frames = rand_frames(4, seed=5)
        np.testing.assert_array_equal(cli.predict(frames), frames[..., 0])
        assert cli.stats()["frames"] >= 4
    finally:
        assert cli.close_server()["ok"]
        srv.join(timeout=10)
        assert not srv.is_alive()
        cli.close()
        eng.close()
    # sim/server.py framing: JSON header then the raw buffer
    ctx = zmq.Context.instance()
    a, b = ctx.socket(zmq.PAIR), ctx.socket(zmq.PAIR)
    pp = a.bind_to_random_port("tcp://127.0.0.1")
    b.connect(f"tcp://127.0.0.1:{pp}")
    try:
        arr = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
        send_array(a, arr)
        np.testing.assert_array_equal(recv_array(b), arr)
    finally:
        a.close(0)
        b.close(0)


def test_zmq_stats_mean_latency_is_per_request():
    """Two-frame requests: the mean latency is over requests, each at
    least the predictor's 20 ms (over frames it read half that)."""
    zmq = pytest.importorskip("zmq")

    def predict(frames):
        time.sleep(0.02)
        return frames[..., 0]

    eng = BatchingEngine(predict, height=H, width=W, max_batch=8,
                         max_wait_ms=1.0)
    res = zmq.Context.instance().socket(zmq.REP)
    port = res.bind_to_random_port("tcp://127.0.0.1")
    res.close(0)
    time.sleep(0.05)
    ready = threading.Event()
    srv = threading.Thread(target=serve_inference, kwargs=dict(
        engine=eng, host="127.0.0.1", port=port, ready=ready, warmup=False),
        daemon=True)
    srv.start()
    assert ready.wait(10)
    cli = SegmentationClient("127.0.0.1", port, timeout_s=30)
    try:
        for seed in range(3):
            cli.predict(rand_frames(2, seed=seed))
        s = cli.stats()
    finally:
        assert cli.close_server()["ok"]
        srv.join(timeout=10)
        assert not srv.is_alive()
        cli.close()
        eng.close()
    assert (s["requests"], s["frames"]) == (3, 6)
    assert s["mean_latency_ms"] == pytest.approx(
        1e3 * s["latency_sum_s"] / 3)
    assert s["mean_latency_ms"] >= 20.0


# -- without a card -----------------------------------------------------------

def test_entry_points_need_a_card_unless_cpu(monkeypatch, weights):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SupervisedTrainer(model=build_model("tiny", 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_trainer_and_state("baseline", weights[0], arch="tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.build_predict_fn(_args(weights[0], "--fused"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.build_predict_fn(_lite_args("--int8", "--fused"))


@pytest.mark.parametrize("what", ["67r", "encdec", "mme"])
def test_not_yet_ported_raises(weights, what, tmp_path):
    """What raised until it was ported now runs: the archs ``67r`` and
    ``encdec`` build and serve, and ``cli/train.py --trainType mme
    --fast_train`` trains (only ``cli.domain_study``'s render of a
    missing domain still raises)."""
    from helpers import make_simreal_tree

    from sim2real_lane_segment_tpu_torch.cli import train as train_cli

    if what == "mme":
        root = make_simreal_tree(tmp_path, np.random.default_rng(7))
        res = train_cli.main(["--trainType", "mme", "--dataPath", root,
                              "--pretrained_path", weights[0], "--arch",
                              "tiny", "--fast_train", "--max_epochs", "1",
                              "-b", "4", "--height", str(H), "--width",
                              str(W), "--default_root_dir",
                              str(tmp_path / "o")], device="cpu")
        assert np.isfinite(res["best_iou"])
        return
    model = build_model(what, 4)  # 67r: five 2x2 pools, so 32x32 frames
    trainer = SupervisedTrainer(model=model, height=32, width=32,
                                device="cpu")
    frames = rand_frames(2, h=32, w=32)
    assert trainer.predict_step(frames).shape == (2, 32, 32)


# -- LaneNetLite: the default arch, float, int8 and int8 through K6 ----------

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "lanenet_lite_sim.msgpack")
LITE_MODES = {"float": [], "float_fused": ["--fused"], "int8": ["--int8"],
              "int8_fused": ["--int8", "--fused"]}


def _lite_args(*extra, h=48, w=64):
    return port_serve.parse_args(["--checkpointPath", ART, "--height", str(h),
                                  "--width", str(w), *extra])


@pytest.mark.parametrize("mode", list(LITE_MODES))
def test_lite_predict_fn_serves_committed_student(mode):
    """Every LaneNetLite mode answers host uint8 masks behind the engine,
    each request as the predictor gives it alone."""
    predict, h, w = port_serve.build_predict_fn(
        _lite_args(*LITE_MODES[mode]), device="cpu")
    assert (h, w) == (48, 64)
    frames = rand_frames(5, seed=30, h=h, w=w)
    masks = predict(frames)
    assert isinstance(masks, np.ndarray) and masks.dtype == np.uint8
    assert masks.shape == (5, h, w) and masks.max() < 4
    eng = BatchingEngine(predict, height=h, width=w, max_batch=8,
                         max_wait_ms=5.0)
    try:
        np.testing.assert_array_equal(eng.predict(frames[:3], timeout=60),
                                      predict(frames[:3]))
    finally:
        eng.close()


def test_lite_is_the_default_arch_at_full_size():
    """``cli.serve --checkpointPath <student>`` with no other flag."""
    args = port_serve.parse_args(["--checkpointPath", ART])
    assert (args.arch, args.int8, args.fused) == ("lite", False, False)
    predict, h, w = port_serve.build_predict_fn(args, device="cpu")
    assert predict(rand_frames(1, seed=31, h=h, w=w)).shape == (1, 120, 160)


def test_lite_fused_without_int8_is_the_plain_module_and_trains():
    """No kernel stands behind ``--arch lite --fused`` alone (as in JAX):
    ``predict_step_fused`` is ``predict_step``.  The committed student's
    trainer also trains (formerly refused): one step moves its weights
    and running statistics and logs finite values."""
    tr = load_trainer_and_state("baseline", ART, arch="lite", height=48,
                                width=64, device="cpu", policy=F32_POLICY)
    frames = rand_frames(2, seed=32, h=48, w=64)
    assert torch.equal(tr.predict_step_fused(frames), tr.predict_step(frames))
    before = {k: t.clone() for k, t in tr.model.state_dict().items()}
    labels = np.zeros((2, 48, 64), np.uint8)
    labels[:, :, 32:] = 1
    logs = tr.train_step(frames, labels, 1e-3)
    assert all(np.isfinite(float(v)) for v in logs.values())
    after = tr.model.state_dict()
    for k in ("featureExtractor.ConvBN_0.Conv_0.weight",
              "featureExtractor.ResBlock_4.BatchNorm_0.running_mean"):
        assert not torch.equal(after[k], before[k]), k


def test_lite_predict_matches_jax_trainer():
    """The committed student through both trainers' ``predict_step``, in
    float32: at least 99.9% of pixels agree (the x4 upsample and the convs
    sum in another order, which can flip a near tie)."""
    from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
    from sim2real_lane_segment_tpu.models.lanenet_lite import LaneNetLite
    from sim2real_lane_segment_tpu.train import checkpoint as jax_ckpt

    jt = JaxTrainer(model=LaneNetLite(n_classes=4, policy=JAX_F32), height=48,
                    width=64, augment=False)
    state = jax_ckpt.load_weights(ART, jt.init_state(jax.random.key(0)))
    tr = load_trainer_and_state("baseline", ART, arch="lite", height=48,
                                width=64, device="cpu", policy=F32_POLICY)
    frames = rand_frames(3, seed=33, h=96, w=128)
    ref = np.asarray(jt.predict_step(state, frames))
    out = tr.predict_step(frames).numpy()
    assert out.shape == ref.shape == (3, 48, 64)
    assert (out == ref).mean() >= 0.999


def test_calib_dir_resizes_pngs_as_jax_does(tmp_path, monkeypatch):
    """``--calib_dir`` PNGs at any size (formerly refused): the frames the
    port calibrates on are cv2's LANCZOS4 resize bit for bit (a frame
    already at the size comes back unchanged, as cv2 copies it), and the int8
    scales equal those of the JAX ``build_predict_fn`` on the same PNGs
    within 4 ulp (``test_torch_lanenet_int8``'s limit; here each package
    also normalizes the frames itself, which may round the first site's
    input apart)."""
    import cv2

    from sim2real_lane_segment_tpu.cli import serve as jax_serve
    from sim2real_lane_segment_tpu.models import lanenet_int8 as jint8
    from sim2real_lane_segment_tpu_torch.data.png import write_png
    from sim2real_lane_segment_tpu_torch.models import lanenet_int8

    calib = tmp_path / "calib"
    calib.mkdir()
    for i, (h, w) in enumerate([(H, W), (H + 7, W + 13), (96, 128)]):
        write_png(str(calib / f"{i:03d}.png"),
                  rand_frames(1, seed=40 + i, h=h, w=w)[0])
    argv = ["--checkpointPath", ART, "--height", str(H), "--width", str(W),
            "--int8", "--calib_dir", str(calib)]
    frames = port_serve.calibration_frames(port_serve.parse_args(argv),
                                           "cpu").numpy()
    want = np.stack([cv2.resize(cv2.imread(str(p)), (W, H),
                                interpolation=cv2.INTER_LANCZOS4)
                     for p in sorted(calib.iterdir())])
    np.testing.assert_array_equal(frames, want)

    seen = {}

    def spy(name, real):
        def f(*a, **kw):
            seen[name] = real(*a, **kw)
            return seen[name]
        return f

    monkeypatch.setattr(jint8, "quantize_lanenet",
                        spy("jax", jint8.quantize_lanenet))
    monkeypatch.setattr(lanenet_int8, "quantize_lanenet",
                        spy("port", lanenet_int8.quantize_lanenet))
    # the flags are the JAX CLI's (test_serve_flags_match_jax_cli)
    jax_serve.build_predict_fn(port_serve.parse_args(argv))
    predict, _, _ = port_serve.build_predict_fn(
        port_serve.parse_args(argv), device="cpu")
    assert predict(rand_frames(2, seed=43)).shape == (2, H, W)
    assert list(seen["port"].sites) == list(seen["jax"].sites)
    for name, js in seen["jax"].sites.items():
        got = seen["port"].sites[name]["act_scale"].numpy()
        np.testing.assert_array_max_ulp(got, np.asarray(js["act_scale"]), 4)
    with pytest.raises(FileNotFoundError):
        port_serve.build_predict_fn(
            _lite_args("--int8", "--calib_dir", str(tmp_path / "none")),
            device="cpu")


def test_int8_requires_lite(weights):
    with pytest.raises(SystemExit, match="--arch lite"):
        port_serve.build_predict_fn(_args(weights[0], "--int8"),
                                    device="cpu")


def test_serve_flags_match_jax_cli():
    """The port's serve CLI keeps the JAX CLI's flags."""
    import inspect

    from sim2real_lane_segment_tpu.cli import serve as jax_serve
    src = inspect.getsource(jax_serve.main)
    for flag in vars(port_serve.parse_args(["--checkpointPath", "x"])):
        assert f'"--{flag}"' in src, flag
