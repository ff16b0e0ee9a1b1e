"""Program spans: one in-memory recorder for the whole process.

``span(name, **attrs)`` is a context manager that times a stretch of the
program's host work.  A closed span holds its name, its id, its parent's
id (0 at the top; the parent is the innermost open span of the same
thread), its start and end by ``time.monotonic_ns()``, its thread and a
few attributes.  A span opened inside one that carries a ``batch`` or a
``step`` attribute carries it too, so the spans of one served batch or
one train step share one identifier.

Closed spans go into a ring of ``RING`` entries; ``spans()`` reads it and
``dropped()`` counts the spans it no longer holds.  Nothing is written
to disk, and the ring is always on: a span costs one to two
microseconds, and the program opens a few per served batch or train
step.  ``record`` adds a span timed elsewhere, such as one of several
that overlap on one thread.  Counters stay where they are
(``serving.BatchingEngine.stats``, ``train.graphs.counts``, the kernel
wrappers' ``launches``).  The module imports nothing from torch, so
callers that never load torch (``serving.SegmentationClient``) need none.

While a ``torch.profiler`` session runs in the process (torch loaded and
its profiler on), each span is also entered as a profiler event of its
name, so the program's spans sit in the profiler's timeline beside the
device's kernels and copies.  The event has an operator's scope (``_RecordFunctionFast``): the user scope
of ``torch.profiler.record_function`` would also make the profiler lay a
device-side annotation over the span's kernels, which reads as device
time.  The profiler keeps such an event only from a thread it records:
the thread that started it, or every thread with its
``profile_all_threads`` option.  The profiler's host clock may be another
than ``time.monotonic``; one constant offset maps the ring's stamps onto
it.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque

RING = 65536
INHERITED = ("batch", "step")

_ring: deque = deque(maxlen=RING)
_ids = itertools.count(1)      # a span's id, when it opens
_closed = itertools.count(1)   # closed spans, counted as they close
_local = threading.local()
_event = None  # torch's op-scope profiler event, imported when first needed


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """``span(name, **attrs)``: a span named ``name`` with attributes
    ``attrs`` (which may be set while it is open), recorded when it
    closes."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "thread", "attrs",
                 "seq", "_mirror")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = self.t0 = self.t1 = self.seq = 0
        self.thread = threading.get_ident()
        self._mirror = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def _adopt(self, stack: list) -> None:
        """Take the innermost open span as the parent."""
        if stack:
            up = stack[-1]
            self.parent = up.id
            if up.attrs:
                for key in INHERITED:
                    if key in up.attrs and key not in self.attrs:
                        self.attrs[key] = up.attrs[key]

    def _close(self) -> None:
        self.seq = next(_closed)
        _ring.append(self)

    def __enter__(self) -> "span":
        stack = _stack()
        self._adopt(stack)
        stack.append(self)
        profiler = sys.modules.get("torch.autograd.profiler")
        if profiler is not None and profiler._is_profiler_enabled:
            self._mirror = _mirror(self.name)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._mirror is not None:
            # stamped after the profiler's end stamp, which comes late in
            # the exit: the two clocks then differ by one offset
            self._mirror.__exit__(None, None, None)
            self._mirror = None
        self.t1 = time.monotonic_ns()
        _stack().pop()
        self._close()


def _mirror(name: str):
    """An entered profiler event named ``name``."""
    global _event
    if _event is None:
        from torch._C._profiler import _RecordFunctionFast as _event
    event = _event(name)
    event.__enter__()
    return event


def record(name: str, t0: int, t1: int, **attrs) -> span:
    """Record a span named ``name`` that ran from ``t0`` to ``t1``
    (``time.monotonic_ns()``); its parent is the innermost open span.
    It is not mirrored into a profiler."""
    s = span(name, **attrs)
    s._adopt(_stack())
    s.t0, s.t1 = t0, t1
    s._close()
    return s


def spans() -> list[span]:
    """The ring's spans, in the order they closed."""
    return list(_ring)


def dropped() -> int:
    """Spans closed since the process started that the ring no longer
    holds."""
    ring = list(_ring)
    return max((s.seq for s in ring), default=0) - len(ring)
