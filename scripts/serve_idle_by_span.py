#!/usr/bin/env python3
"""A serving cell's idle device time, split over the program's spans.

    python3 scripts/serve_idle_by_span.py --workload fcd67.serve_fleet \
        --seed 7 --seconds 30

One ``portbench/run.py --trace 1`` run of the cell, its profiled stretch
as the benchmark takes it. The batching engine's spans (``core/tracing``)
run on the engine's thread, which that stretch does not record, so they
are read from the ring instead and put on the profiler's clock by one
offset: that of a span opened on the profiling thread just after the
stretch starts (and of another just before it stops, to check it).
Prints the run's line, then one line ``idle_by_span {...}``: ``idle_s``,
the idle seconds between the stretch's first and last device operation,
each idle instant put down to the innermost program span open then, on
any thread (``none`` where none is open), largest first; ``spans``, the
program spans inside the stretch, by name; ``offset_ns``, the two
offsets from the ring's clock to the profiler's. Needs one CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import sys
from collections import Counter, defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK = "idle_by_span.clock"


def split_idle(busy: list, spans: list) -> dict:
    """Idle nanoseconds between the first and last of the device's busy
    intervals ``busy`` [(start, end)], by the innermost host span open at
    each idle instant: of ``spans`` [(start, end, name)] open then, the
    one that opened last (spans nest within a thread)."""
    idle, end = [], None
    for a, b in sorted(busy):
        if end is not None and a > end:
            idle.append((end, a))
        end = b if end is None else max(end, b)
    starts = np.array([s[0] for s in spans], dtype=np.int64)
    ends = np.array([s[1] for s in spans], dtype=np.int64)
    out: dict = defaultdict(int)
    for a, b in idle:
        over = np.nonzero((starts < b) & (ends > a))[0]
        cuts = sorted({a, b} | {int(x) for i in over
                                for x in (starts[i], ends[i]) if a < x < b})
        for lo, hi in zip(cuts, cuts[1:]):
            open_ = [i for i in over if starts[i] <= lo and ends[i] >= hi]
            name = (spans[max(open_, key=lambda i: starts[i])][2] if open_
                    else "none")
            out[name] += hi - lo
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None, **run_kw) -> int:
    """The command; ``run_kw`` goes on to ``portbench/run.py``'s ``main``
    (its tests' keywords, for a run on the CPU)."""
    sys.path.insert(0, ROOT)
    import torch

    from portbench import run, trace
    from portbench.harness import PORT

    tracing = __import__(f"{PORT}.core.tracing", fromlist=["span"])
    found = {}
    clocks = []
    start, stop, reduce = (trace.Stretch.start, trace.Stretch.stop,
                           trace.Stretch.reduce)

    def start_clocked(self):
        start(self)
        with tracing.span(CLOCK) as c:
            clocks.append(c)

    def stop_clocked(self):
        with tracing.span(CLOCK) as c:
            clocks.append(c)
        stop(self)

    def split_too(self, port_names):
        busy, marks = [], []
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns()
            if e.device_type() != torch.autograd.DeviceType.CPU:
                busy.append((a, a + e.duration_ns()))
            elif e.name() == CLOCK:
                marks.append(a)
        offsets = [c.t0 - m for c, m in zip(clocks[-2:], sorted(marks))]
        found["offset_ns"] = offsets
        off = offsets[0] if offsets else 0
        t0, t1 = clocks[-2].t0, clocks[-1].t1
        host = [(s.t0 - off, s.t1 - off, s.name) for s in tracing.spans()
                if s.name != CLOCK and s.t1 > t0 and s.t0 < t1]
        found["idle_s"] = {k: v * 1e-9 for k, v in
                           split_idle(busy, host).items()}
        found["spans"] = dict(Counter(h[2] for h in host))
        return reduce(self, port_names)

    trace.Stretch.start = start_clocked
    trace.Stretch.stop = stop_clocked
    trace.Stretch.reduce = split_too
    args = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(args + ["--trace", "1"], **run_kw)
    if rc == 0:
        print("idle_by_span", json.dumps(found), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
