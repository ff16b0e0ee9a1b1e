"""``scripts/serve_idle_by_span.py``: the split of idle device time over
the program's spans, and a traced serving run on the CPU that reads the
engine thread's spans inside the stretch and one clock offset."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


script = load("scripts/serve_idle_by_span.py", "serve_idle_by_span")


@pytest.mark.parametrize("busy, spans, want", [
    # one gap (10, 20): a span over all of it
    ([(0, 10), (20, 30)], [(5, 25, "a")], {"a": 10}),
    # nested: the inner one where it is open, the outer around it
    ([(0, 10), (20, 30)], [(0, 30, "outer"), (12, 15, "inner")],
     {"outer": 7, "inner": 3}),
    # no span open for part of the gap; overlapping busy intervals
    ([(0, 10), (5, 12), (20, 30)], [(15, 40, "a")], {"none": 3, "a": 5}),
    # two gaps, spans of two threads: the one that opened last
    ([(0, 10), (20, 30), (40, 50)], [(8, 45, "x"), (18, 35, "y")],
     {"x": 13, "y": 7}),
    # no gap at all
    ([(0, 10), (10, 20)], [(0, 20, "a")], {}),
])
def test_idle_is_split_over_the_innermost_open_span(busy, spans, want):
    got = script.split_idle(busy, spans)
    assert got == want
    assert list(got.values()) == sorted(got.values(), reverse=True)


def test_the_stretch_reads_the_engine_threads_spans():
    """A tiny fleet cell on the CPU, in a process of its own (the run
    refuses one that has loaded JAX, as this test process may have)."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {tests!r}]\n"
        "import portbench_tiny as t\n"
        "from scripts import serve_idle_by_span as s\n"
        "sys.exit(s.main(['--workload', t.CELLS['fleet'], '--seed', "
        "'{seed}', '--seconds', '1.5'], device='cpu', cfg=t.TINY, "
        "traffic=t.traffic('fleet'), limits=t.TINY_LIMITS))\n").format(
            root=ROOT, tests=os.path.join(ROOT, "portbench", "tests"),
            seed=2 ** 33 + 5)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-4000:]
    lines = got.stdout.strip().splitlines()
    assert json.loads(lines[-2])["correct"]
    label, found = lines[-1].split(" ", 1)
    assert label == "idle_by_span"
    found = json.loads(found)
    assert found["idle_s"] == {}  # no device events on the CPU
    spans = found["spans"]
    for name in ("engine.gather", "engine.assemble", "engine.predict",
                 "engine.reply", "serve.upload", "serve.launch",
                 "serve.download"):
        assert spans.get(name, 0) > 0, spans
    first, last = found["offset_ns"]  # one offset, start and stop
    assert abs(first - last) < 200_000, found["offset_ns"]
