"""The port's serving path on the CPU: ``BatchingEngine`` behaviours
(mirroring tests/test_serving.py), the CLI predictor, the fused predict
step against the JAX one on the same ``.npz`` weights, weight files, and
entry points that must refuse to run without a card."""
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
        load_weights(str(tmp_path / "w.msgpack"), model)


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


@pytest.mark.parametrize("what", ["lite", "67r", "encdec", "mme", "int8"])
def test_not_yet_ported_raises(weights, what):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        if what == "mme":
            load_trainer_and_state("mme", weights[0], arch="tiny",
                                   device="cpu")
        elif what == "int8":
            port_serve.build_predict_fn(_args(weights[0], "--int8"),
                                        device="cpu")
        else:
            build_model(what, 4)


def test_serve_flags_match_jax_cli():
    """The port's serve CLI keeps the JAX CLI's flags."""
    import inspect

    from sim2real_lane_segment_tpu.cli import serve as jax_serve
    src = inspect.getsource(jax_serve.main)
    for flag in vars(port_serve.parse_args(["--checkpointPath", "x"])):
        assert f'"--{flag}"' in src, flag
