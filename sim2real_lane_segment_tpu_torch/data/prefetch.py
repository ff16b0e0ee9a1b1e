"""Host batch prefetching on a reader thread.

Counterpart of ``background_batches`` in the JAX package's
``data/prefetch.py``: a thread reads and stacks the next batches while
the card computes; batches stay uint8 numpy until the step copies them.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class _Error:
    """Carries a reader-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_SENTINEL = object()


def _pump(q: queue.Queue, stop: threading.Event, it: Iterator) -> None:
    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    try:
        for batch in it:
            if not put(batch):
                return
    except BaseException as e:  # re-raised in the consumer
        put(_Error(e))
        return
    put(_SENTINEL)


def background_batches(make_iter: Callable[[], Iterator],
                       size: int = 4) -> Iterator:
    """Iterate ``make_iter()`` with up to ``size`` batches read ahead on a
    thread.  Abandoning the iterator stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    threading.Thread(target=_pump, args=(q, stop, make_iter()),
                     daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, _Error):
                raise item.exc
            yield item
    finally:
        stop.set()
