"""The port's span recorder (``core.tracing``) and the spans the program
opens with it: nesting and threads, the ring's bound, the mirror into
``torch.profiler`` and its clock, the engine's four spans a batch, the
train step's spans and the served step's, all on the CPU."""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sim2real_lane_segment_tpu_torch.cli import serve as port_serve
from sim2real_lane_segment_tpu_torch.cli.test import build_model
from sim2real_lane_segment_tpu_torch.core import tracing
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.core.tracing import span
from sim2real_lane_segment_tpu_torch.serving import BatchingEngine, _bucket
from sim2real_lane_segment_tpu_torch.train.supervised import SupervisedTrainer

H, W = 24, 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def since(t0: int, name: str | None = None) -> list:
    """The spans that opened at ``t0`` (monotonic ns) or later."""
    return [s for s in tracing.spans()
            if s.t0 >= t0 and (name is None or s.name == name)]


def test_nested_spans_name_their_parent_and_inherit_the_batch():
    t0 = time.monotonic_ns()
    with span("t.outer", batch=7) as outer:
        with span("t.mid", k=1) as mid:
            with span("t.inner"):
                pass
        with span("t.sibling", batch=8):
            pass
    by = {s.name: s for s in since(t0)}
    assert by["t.outer"].parent == 0
    assert by["t.mid"].parent == outer.id
    assert by["t.inner"].parent == mid.id
    assert by["t.sibling"].parent == outer.id
    assert by["t.mid"].attrs == {"k": 1, "batch": 7}
    assert by["t.inner"].attrs == {"batch": 7}
    assert by["t.sibling"].attrs == {"batch": 8}  # its own is kept
    assert outer.t0 <= mid.t0 <= mid.t1 <= outer.t1
    assert [s.name for s in since(t0)] == ["t.inner", "t.mid", "t.sibling",
                                           "t.outer"]
    assert len({s.id for s in since(t0)}) == 4


def test_threads_keep_their_own_stacks():
    t0 = time.monotonic_ns()
    inside = threading.Event()
    go_on = threading.Event()

    def other():
        with span("t.thread_outer"):
            inside.set()
            assert go_on.wait(10)
            with span("t.thread_inner"):
                pass

    with span("t.main_outer") as main:
        th = threading.Thread(target=other)
        th.start()
        assert inside.wait(10)
        with span("t.main_inner"):  # the other thread's span is open
            pass
        go_on.set()
        th.join(10)
    assert not th.is_alive()
    by = {s.name: s for s in since(t0)}
    assert by["t.main_inner"].parent == main.id
    assert by["t.thread_outer"].parent == 0
    assert by["t.thread_inner"].parent == by["t.thread_outer"].id
    assert by["t.thread_inner"].thread == by["t.thread_outer"].thread
    assert by["t.thread_inner"].thread != main.thread


def test_the_ring_is_bounded_and_counts_what_it_dropped():
    before = tracing.dropped()
    held = len(tracing.spans())
    extra = tracing.RING - held + 25
    for i in range(extra):
        with span("t.fill", i=i):
            pass
    got = tracing.spans()
    assert len(got) == tracing.RING
    assert tracing.dropped() == before + 25
    assert got[-1].attrs == {"i": extra - 1}
    assert [s.seq for s in got[-3:]] == [got[-1].seq - 2, got[-1].seq - 1,
                                         got[-1].seq]


def test_no_profiler_event_without_a_profiler(monkeypatch):
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name, *a):
        made.append(name)
        return real(name, *a)

    monkeypatch.setattr(tracing, "_event", counted)
    with span("t.quiet"):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("t.mirrored"):
            pass
    assert made == ["t.mirrored"]


def spin(seconds: float) -> None:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass


def test_mirrored_spans_are_host_events_one_offset_from_the_ring():
    names = [f"t.clock{i}" for i in range(6)]
    t0 = time.monotonic_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.clock_warm"):  # the mirror's first entry is slow
            pass
        for name in names:
            with span(name):
                spin(0.002)
            spin(0.001)
    ring = {s.name: s for s in since(t0) if s.name in names}
    host = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            host[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    assert set(host) == set(names)
    offsets = [ring[n].t0 - host[n][0] for n in names]
    offsets += [ring[n].t1 - host[n][1] for n in names]
    assert max(offsets) - min(offsets) < 200_000, offsets


def test_engine_spans_each_batch_with_its_stamps():
    def predict(frames):
        time.sleep(0.003)
        return frames[..., 0]

    sizes = [1, 2, 1, 3, 4, 2, 1]
    t0 = time.monotonic_ns()
    eng = BatchingEngine(predict, height=H, width=W, max_batch=4,
                         max_wait_ms=20.0)
    try:
        rng = np.random.default_rng(0)
        pending = [eng.submit(rng.integers(0, 255, (k, H, W, 3), np.uint8))
                   for k in sizes]
        for p in pending:
            p.wait(30)
    finally:
        eng.close()
    by_batch: dict = {}
    for s in since(t0):
        if s.name.startswith("engine."):
            by_batch.setdefault(s.attrs["batch"], {})[s.name] = s
    assert by_batch and all(
        set(b) == {"engine.gather", "engine.assemble", "engine.predict",
                   "engine.reply"} for b in by_batch.values())
    queue = list(zip(pending, sizes))
    for bid in sorted(by_batch):
        b = by_batch[bid]
        g, a, p, r = (b["engine.gather"], b["engine.assemble"],
                      b["engine.predict"], b["engine.reply"])
        assert g.t1 <= a.t0 and a.t1 <= p.t0 and p.t1 <= r.t0
        n = g.attrs["requests"]
        assert p.attrs["requests"] == n
        mine, queue = queue[:n], queue[n:]
        assert g.attrs["frames"] == sum(k for _, k in mine)
        assert a.attrs["padded"] == _bucket(g.attrs["frames"], 4)
        assert p.attrs["wait_ns"] == sum(p.t0 - q.t_submit_ns
                                         for q, _ in mine)
    assert queue == []
    assert eng.stats["requests"] == len(sizes)
    assert eng.stats["frames"] == sum(sizes)


def test_scan_chunk_spans_each_step_under_its_chunk():
    model = build_model("tiny", 4, F32_POLICY)
    trainer = SupervisedTrainer(num_cls=4, height=H, width=W, model=model,
                                device="cpu")
    rng = np.random.default_rng(1)
    arrays = (torch.from_numpy(rng.integers(0, 255, (6, H, W, 3), np.uint8)),
              torch.from_numpy(rng.integers(0, 4, (6, H, W), np.uint8)))
    gen = torch.Generator().manual_seed(2)
    t0 = time.monotonic_ns()
    trainer.run_scan_chunk(arrays, np.array([[0, 1], [2, 3]]), gen, 0)
    trainer.run_scan_chunk(arrays, np.array([[4, 5]]), gen, 0)
    got = since(t0)
    chunks = [s for s in got if s.name == "train.chunk"]
    assert [(c.attrs["step"], c.attrs["steps"]) for c in chunks] == \
        [(0, 2), (2, 1)]
    for name in ("train.draw", "train.step"):
        steps = [s for s in got if s.name == name]
        assert [s.attrs["step"] for s in steps] == [0, 1, 2]
        assert [s.parent for s in steps] == [chunks[0].id, chunks[0].id,
                                             chunks[1].id]
    assert not [s for s in got if s.name in ("train.stage", "train.replay",
                                             "train.capture")]
    assert trainer.steps_run == 3


def test_served_step_spans_nest_under_the_engine_predict(tmp_path):
    path = str(tmp_path / "tiny.pt")
    torch.save(build_model("tiny", 4).state_dict(), path)
    args = port_serve.parse_args(["--checkpointPath", path, "--arch", "tiny",
                                  "--fused", "--height", str(H), "--width",
                                  str(W)])
    predict, _, _ = port_serve.build_predict_fn(args, device="cpu")
    t0 = time.monotonic_ns()
    eng = BatchingEngine(predict, height=H, width=W, max_batch=4,
                         max_wait_ms=1.0)
    try:
        for k in (3, 1):
            eng.predict(np.zeros((k, H, W, 3), np.uint8), timeout=60)
    finally:
        eng.close()
    got = since(t0)
    predicts = [s for s in got if s.name == "engine.predict"]
    assert len(predicts) == 2
    for i, p in enumerate(predicts):
        kids = [s.name for s in got if s.parent == p.id]
        assert kids == ["serve.upload", "serve.launch", "serve.download"]
        assert all(s.attrs["batch"] == p.attrs["batch"] for s in got
                   if s.parent == p.id)
        assert sum(s.seconds for s in got if s.parent == p.id) <= p.seconds


@pytest.mark.parametrize("built", [0, 1])
def test_setup_load_span_times_the_build(tmp_path, monkeypatch, built):
    from sim2real_lane_segment_tpu_torch.kernels import build

    src = tmp_path / "csrc"
    src.mkdir()
    name = f"traced{built}_{tmp_path.name}"
    (src / f"{name}.cpp").write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if not built:  # built before: the span loads it only
        build.build(name)
    t0 = time.monotonic_ns()
    assert build.load(name).one() == 1
    assert build.load(name).one() == 1  # loaded once
    loads = since(t0, "setup.load")
    assert [s.attrs for s in loads] == [{"lib": name}]
    builds = since(t0, "setup.build")
    if built:
        assert [(s.attrs, s.parent) for s in builds] == \
            [({"lib": name}, loads[0].id)]
        assert loads[0].t0 <= builds[0].t0 <= builds[0].t1 <= loads[0].t1
        assert build.build_seconds()[name] == builds[0].seconds > 0
    else:
        assert builds == []
        assert build.build_seconds()[name] > 0  # the earlier build's


def test_recorded_span_takes_its_stamps_and_the_open_parent():
    with span("t.record_outer", step=4) as outer:
        got = tracing.record("t.recorded", 10, 30, lib="x")
    assert tracing.spans()[-2] is got
    assert (got.t0, got.t1, got.parent) == (10, 30, outer.id)
    assert got.attrs == {"lib": "x", "step": 4}
    assert got.seq == outer.seq - 1
    top = tracing.record("t.recorded_top", 5, 6)
    assert top.parent == 0 and tracing.spans()[-1] is top


def test_serving_and_the_recorder_load_without_torch():
    """The engine and its client need numpy only; the recorder imports
    torch's profiler only while a profiler runs."""
    code = ("import sys; import sim2real_lane_segment_tpu_torch.serving; "
            "from sim2real_lane_segment_tpu_torch.core.tracing import span\n"
            "with span('t.no_torch'): pass\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == "
            "'torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's device events")
    return torch.device("cuda")


@pytest.mark.gpu
def test_mirrored_spans_add_no_device_events(cuda):
    """The mirror is an operator-scope event: a span over kernels leaves
    the device's events to the kernels (a user-scope ``record_function``
    would add a device-side annotation, which reads as device time)."""
    x = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("t.gpu_mirror"):
            for _ in range(4):
                x.mul_(1.0001)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() == cpu]
    dev = [e.name() for e in events if e.device_type() != cpu]
    assert host.count("t.gpu_mirror") == 1
    assert len(dev) >= 4 and "t.gpu_mirror" not in dev


def test_span_cost_script_times_each_kind(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "span_cost", os.path.join(ROOT, "scripts", "span_cost.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    closed = len(tracing.spans()) and tracing.spans()[-1].seq
    got = mod.main(["--n", "300", "--reps", "2"])
    for key in ("empty_loop_us", "top_us", "nested_us", "mirrored_us"):
        assert len(got[key]) == 2 and all(v > 0 for v in got[key]), key
    assert got["ring"][0] == min(tracing.RING, len(tracing.spans()))
    assert got["ring"][1] >= closed + 2 * (3 * 300 + 1)
    assert capsys.readouterr().out.startswith("SPANCOST {")
