"""The program's own spans in a run's window, for the ``program_span``
readers.

The program records its spans in the ring of its ``core.tracing``
module; a program without that module has none to read, and every
function here then gives None. A serving window runs from the start of
the window's first predictor call to the end of its last
(``rec["batches"]``); a training window is its chunks that were not
profiled (``rec["chunks"]``). Spans that overlap the profiled stretch
are left out, so that the profiler's cost does not enter them. Where
the ring dropped spans that may lie in the window, nothing is read.
"""
from __future__ import annotations

import importlib

from portbench.harness import PORT


def _ring():
    try:
        return importlib.import_module(f"{PORT}.core.tracing")
    except ImportError:
        return None


def _read(since: float):
    """The ring's spans, or None where there is no ring or it dropped
    spans that ended at ``since`` (monotonic seconds) or later."""
    tracing = _ring()
    if tracing is None:
        return None
    got = tracing.spans()
    if tracing.dropped() and (not got or got[0].t1 * 1e-9 >= since):
        return None
    return got


def _intervals(rec: dict) -> list:
    if rec.get("kind") == "serve":
        b = rec["batches"]
        return [(b[0][0], b[-1][1])] if b else []
    if rec.get("kind") == "train":
        return [(a, b) for a, b, profiled in rec["chunks"] if not profiled]
    return []


def window(rec: dict, names) -> dict | None:
    """The spans named in ``names`` inside the window of ``rec`` and
    outside its profiled stretch, by name: None where nothing can be
    read."""
    inside = _intervals(rec)
    if not inside:
        return None
    got = _read(inside[0][0])
    if got is None:
        return None
    t = rec.get("trace")
    stretch = (t["t_start"], t["t_stop"]) if t else (0.0, 0.0)
    out = {n: [] for n in names}
    for s in got:
        if s.name not in out:
            continue
        a, b = s.t0 * 1e-9, s.t1 * 1e-9
        if a < stretch[1] and b > stretch[0]:
            continue
        if any(lo <= a and b <= hi for lo, hi in inside):
            out[s.name].append(s)
    return out


def mean_ms(spans: list) -> float | None:
    """The mean duration of ``spans`` in milliseconds."""
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)


def last_before(rec: dict, name: str):
    """The last span named ``name`` that ended before the window opened
    (a training window's first chunk), or None."""
    if rec.get("kind") != "train" or not rec["chunks"]:
        return None
    t_open = rec["chunks"][0][0]
    got = _read(0.0)
    if got is None:
        return None
    before = [s for s in got if s.name == name and s.t1 * 1e-9 <= t_open]
    return max(before, key=lambda s: s.t1, default=None)


def inside(outer, name: str) -> list:
    """The spans named ``name`` that the span ``outer`` holds (its thread,
    within its start and end)."""
    got = _read(0.0) or []
    return [s for s in got if s.name == name and s.thread == outer.thread
            and outer.t0 <= s.t0 and s.t1 <= outer.t1]
