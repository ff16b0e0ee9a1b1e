"""The readers of the program's own spans (``portbench/spans.py`` and the
``program_span`` metrics that read the port's ``core.tracing`` ring) on
the tiny cells on the CPU."""
import importlib
import sys
import time

import pytest
from portbench_tiny import CELLS, TINY, TINY_LIMITS, harness, run_tiny, \
    traffic

BENCH = harness.benchmark()
SPAN_METRICS = ("engine.wait_ms", "engine.host_ms_per_batch",
                "serve.upload_ms_per_batch", "serve.launch_ms_per_batch",
                "serve.download_ms_per_batch", "train.host_ms_per_step",
                "setup.capture_s", "engine.gather_ms_per_batch",
                "train.replay_wait_ms_per_step")
CARD_ONLY = ("setup.capture_s", "train.replay_wait_ms_per_step")
TRACING = f"{harness.PORT}.core.tracing"


def mine(which: str) -> list:
    cell = CELLS[which]
    return [m["name"] for m in BENCH["per_layer"]
            if m["name"] in SPAN_METRICS and cell in m["workloads"]]


def window_rec(which: str, seed: int = 2 ** 33 + 11) -> dict:
    """One untraced window of a tiny cell, driven as ``harness.run``
    drives it: its record."""
    cell = harness.find(BENCH["workloads"], CELLS[which], "workload")
    ctx = harness.Ctx(cell, TINY, traffic(which), seed, 1.5, False, "cpu",
                      TINY_LIMITS)
    c = harness.driver(ctx.traffic["kind"]).Cell(ctx)
    c.setup()
    res = c.window(time.monotonic())
    c.release()
    return res["rec"]


@pytest.mark.parametrize("which", sorted(CELLS))
def test_each_span_metric_reads_its_cell(which):
    rc, line, err = run_tiny(which, trace=1, seed=2 ** 34 + 3)
    assert rc == 0 and line["correct"], err
    for name in mine(which):
        if name in CARD_ONLY:  # the CPU captures and replays no graph
            assert name not in line["metrics"]
            continue
        assert line["metrics"][name]["value"] > 0, name
    assert not set(SPAN_METRICS) - set(mine(which)) & set(line["metrics"])


def test_engine_wait_agrees_with_queue_in_the_closed_loop():
    """Closed loop: a request's send and its submission are one moment,
    and its batch's predictor call starts as its ``engine.predict`` span
    does, so the two means agree."""
    rec = window_rec("video")
    wait = harness.reader("engine.wait_ms").read(rec)
    queue = harness.reader("engine.queue_ms").read(rec)
    assert wait == pytest.approx(queue, rel=0.05)


def test_readers_of_a_program_without_spans_read_nothing(monkeypatch):
    rec = window_rec("fleet")
    assert harness.reader("engine.wait_ms").read(rec) > 0
    monkeypatch.setitem(sys.modules, TRACING, None)  # import fails
    for name in SPAN_METRICS:
        assert harness.reader(name).read(rec) is None, name


def test_readers_refuse_a_window_the_ring_dropped(monkeypatch):
    from portbench import spans

    rec = window_rec("train")
    reader = harness.reader("train.host_ms_per_step")
    assert reader.read(rec) > 0
    tracing = spans._ring()
    monkeypatch.setattr(tracing, "dropped", lambda: 1)
    held = tracing.spans()
    monkeypatch.setattr(tracing, "spans",
                        lambda: [s for s in held
                                 if s.t0 * 1e-9 >= rec["chunks"][0][0]])
    assert reader.read(rec) is None


def test_capture_is_read_before_the_window_without_the_build():
    """``setup.capture_s``: the last ``train.capture`` before the first
    chunk, less the library builds inside it."""
    tracing = importlib.import_module(TRACING)
    with tracing.span("train.capture"):  # an earlier run's
        pass
    with tracing.span("train.capture") as capture:
        time.sleep(0.02)
        with tracing.span("setup.load", lib="x", built=1) as load:
            time.sleep(0.05)
    t_open = time.monotonic()
    with tracing.span("train.capture"):  # inside the window: not set-up's
        time.sleep(0.01)
    rec = {"kind": "train", "chunks": [(t_open, t_open + 1.0, False)]}
    got = harness.reader("setup.capture_s").read(rec)
    assert got == pytest.approx(capture.seconds - load.seconds)
    assert 0.02 <= got < 0.05
