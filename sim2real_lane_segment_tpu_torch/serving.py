"""Streaming segmentation inference service.

Counterpart of the JAX package's ``serving.py``, with the same wire
protocol and the same batching policy:

- ``BatchingEngine`` aggregates concurrent frame requests into batches
  padded to power-of-two buckets (so a batch shape recurs and the
  device's caches stay warm), and runs ``predict_fn`` on its own thread.
- ``serve_inference`` exposes the engine over numpy-over-zmq framing, one
  ROUTER socket, many concurrent DEALER clients.
- ``SegmentationClient`` is the matching client.

The engine is model-agnostic: ``predict_fn`` maps a uint8 ``(N, H, W, 3)``
numpy batch to a uint8 ``(N, H, W)`` numpy class map.  It must hand back
host numpy (``cli.serve.build_predict_fn`` copies the device result with
``.cpu()``, which waits for the device); anything else fails the batch.
``zmq`` is imported only by the socket functions.

Each batch's cycle is four spans (``core.tracing``), all carrying the
batch's id: ``engine.gather`` (from taking its first request to the
batch closing; ``requests``, ``frames``), ``engine.assemble``
(concatenation and padding; ``padded``, the bucket), ``engine.predict``
(the ``predict_fn`` call; ``requests``, and ``wait_ns``: the sum over
them of the time from their submission to this span's start) and
``engine.reply`` (slicing the result and waking the callers).
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time

import numpy as np

from .core.tracing import span

log = logging.getLogger(__name__)


class _Pending:
    """One submitted request: input frames + a waitable result slot."""

    __slots__ = ("frames", "event", "result", "error", "t_submit_ns")

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.t_submit_ns = time.monotonic_ns()

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if not self.event.wait(timeout):
            raise TimeoutError("inference request timed out")
        if self.error is not None:
            raise self.error
        return self.result


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class BatchingEngine:
    """Aggregates requests into fixed-shape batches for one device model.

    Every batch is padded up to a power-of-two bucket, so the device sees
    at most log2(max_batch)+1 batch shapes.
    """

    def __init__(self, predict_fn, *, height: int = 120, width: int = 160,
                 max_batch: int = 64, max_wait_ms: float = 4.0):
        self.predict_fn = predict_fn
        self.height, self.width = height, width
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._queue: queue.Queue[_Pending | None] = queue.Queue()
        self._held: _Pending | None = None  # overflow from the last drain
        self.stats = {"frames": 0, "batches": 0, "requests": 0,
                      "padded_frames": 0, "latency_sum_s": 0.0,
                      "latency_max_s": 0.0}
        self._batch_id = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="batching-engine")
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, frames: np.ndarray) -> _Pending:
        """frames: (k, H, W, 3) or (H, W, 3) uint8; returns a waitable."""
        frames = np.asarray(frames, np.uint8)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[0] > self.max_batch:
            raise ValueError(
                f"submit of {frames.shape[0]} frames exceeds max_batch="
                f"{self.max_batch}; split the request")
        expect = (self.height, self.width, 3)
        if frames.shape[1:] != expect:
            raise ValueError(f"frame shape {frames.shape[1:]} != {expect}")
        p = _Pending(frames)
        self._queue.put(p)
        return p

    def predict(self, frames: np.ndarray,
                timeout: float | None = 60.0) -> np.ndarray:
        """Blocking convenience: submit + wait."""
        out = self.submit(frames).wait(timeout)
        return out

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=10)

    # -- batch loop ----------------------------------------------------------

    def _drain(self) -> list[_Pending] | None:
        """Collect requests up to max_batch frames or max_wait; None = stop."""
        if self._held is not None:
            first, self._held = self._held, None
        else:
            first = self._queue.get()
            if first is None:
                return None
        self._batch_id += 1
        with span("engine.gather", batch=self._batch_id) as s:
            batch, total = [first], first.frames.shape[0]
            deadline = time.monotonic() + self.max_wait
            while total < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-post the stop sentinel
                    break
                if total + nxt.frames.shape[0] > self.max_batch:
                    self._held = nxt  # goes into the next batch
                    break
                batch.append(nxt)
                total += nxt.frames.shape[0]
            s.attrs.update(requests=len(batch), frames=total)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._drain()
            if batch is None:
                return
            bid = self._batch_id
            with span("engine.assemble", batch=bid) as s:
                frames = np.concatenate([p.frames for p in batch])
                n = frames.shape[0]
                cap = s.attrs["padded"] = _bucket(n, self.max_batch)
                if cap > n:
                    frames = np.concatenate(
                        [frames, np.zeros((cap - n, *frames.shape[1:]),
                                          np.uint8)])
            try:
                with span("engine.predict", batch=bid,
                          requests=len(batch)) as s:
                    s.attrs["wait_ns"] = sum(s.t0 - p.t_submit_ns
                                             for p in batch)
                    masks = self.predict_fn(frames)
                if not isinstance(masks, np.ndarray):
                    raise TypeError(
                        "predict_fn must return a host numpy array, got "
                        f"{type(masks).__name__}")
                with span("engine.reply", batch=bid):
                    masks = masks[:n]
                    off = 0
                    for p in batch:
                        k = p.frames.shape[0]
                        p.result = masks[off:off + k]
                        off += k
                        p.event.set()
            except BaseException as e:  # surface device errors to callers
                for p in batch:
                    p.error = e
                    p.event.set()
                log.exception("batch of %d frames failed", n)
                continue
            now = time.monotonic_ns()
            self.stats["frames"] += n
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["padded_frames"] += cap - n
            lat = [(now - p.t_submit_ns) * 1e-9 for p in batch]
            self.stats["latency_sum_s"] += sum(lat)
            self.stats["latency_max_s"] = max(
                self.stats["latency_max_s"], max(lat))


# -- ZMQ front-end -----------------------------------------------------------


def serve_inference(engine: BatchingEngine, *, host: str = "0.0.0.0",
                    port: int = 8903, ready: threading.Event | None = None,
                    warmup: bool = True) -> None:
    """Blocking ROUTER loop over the engine.

    Wire protocol (DEALER client): request = [json header, raw frame
    buffer]; header = {dtype, shape} (sim/server.py framing) plus an
    optional ``cmd`` of ``stats`` / ``close`` (header-only messages).
    Reply = [json meta, raw mask buffer] or [json] for commands.
    """
    import zmq

    if warmup:  # run the bucket-1 and bucket-max shapes before traffic
        engine.predict(np.zeros((1, engine.height, engine.width, 3),
                                np.uint8))
        engine.predict(np.zeros((engine.max_batch, engine.height,
                                 engine.width, 3), np.uint8))

    ctx = zmq.Context()
    sock = ctx.socket(zmq.ROUTER)
    sock.bind(f"tcp://{host}:{port}")
    log.info("inference server listening on %s:%d (max_batch=%d)",
             host, port, engine.max_batch)
    if ready is not None:
        ready.set()

    replies: queue.Queue[list[bytes]] = queue.Queue()
    stop = threading.Event()

    def on_done(ident: bytes, pending: _Pending) -> None:
        try:
            mask = pending.wait(timeout=120.0)
            header = json.dumps({"ok": True, "dtype": str(mask.dtype),
                                 "shape": mask.shape}).encode()
            replies.put([ident, header, np.ascontiguousarray(mask)
                         .tobytes()])
        except BaseException as e:
            replies.put([ident, json.dumps(
                {"ok": False, "error": repr(e)}).encode()])

    poller = zmq.Poller()
    poller.register(sock, zmq.POLLIN)
    while not stop.is_set():
        # flush finished replies (socket owned by this thread only)
        try:
            while True:
                sock.send_multipart(replies.get_nowait())
        except queue.Empty:
            pass
        if not poller.poll(10):
            continue
        parts = sock.recv_multipart()
        ident, header = parts[0], json.loads(parts[1])
        cmd = header.get("cmd", "predict")
        if cmd == "close":
            sock.send_multipart([ident, json.dumps({"ok": True}).encode()])
            stop.set()
        elif cmd == "stats":
            s = dict(engine.stats)
            s["mean_batch"] = s["frames"] / max(s["batches"], 1)
            s["mean_latency_ms"] = 1e3 * s["latency_sum_s"] / max(
                s["requests"], 1)
            s["ok"] = True
            sock.send_multipart([ident, json.dumps(s).encode()])
        else:
            frames = np.frombuffer(parts[2], dtype=header["dtype"]) \
                .reshape(header["shape"])
            try:
                pending = engine.submit(frames)
            except ValueError as e:
                sock.send_multipart([ident, json.dumps(
                    {"ok": False, "error": str(e)}).encode()])
                continue
            threading.Thread(target=on_done, args=(ident, pending),
                             daemon=True).start()
    # drain any replies still in flight before closing
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end:
        try:
            sock.send_multipart(replies.get(timeout=0.1))
        except queue.Empty:
            break
    sock.close(0)
    ctx.term()


class SegmentationClient:
    """Blocking client for ``serve_inference``; one per thread."""

    def __init__(self, addr: str = "localhost", port: int = 8903,
                 timeout_s: float = 120.0):
        import zmq

        self._ctx = zmq.Context.instance()
        self.sock = self._ctx.socket(zmq.DEALER)
        self.sock.RCVTIMEO = int(timeout_s * 1e3)
        self.sock.connect(f"tcp://{addr}:{port}")

    def predict(self, frames: np.ndarray) -> np.ndarray:
        """(k, H, W, 3) or (H, W, 3) uint8 -> (k, H, W) / (H, W) uint8."""
        frames = np.asarray(frames, np.uint8)
        squeeze = frames.ndim == 3
        if squeeze:
            frames = frames[None]
        header = json.dumps({"dtype": str(frames.dtype),
                             "shape": frames.shape}).encode()
        self.sock.send_multipart([header,
                                  np.ascontiguousarray(frames).tobytes()])
        parts = self.sock.recv_multipart()
        meta = json.loads(parts[0])
        if not meta.get("ok"):
            raise RuntimeError(meta.get("error", "inference failed"))
        mask = np.frombuffer(parts[1], dtype=meta["dtype"]) \
            .reshape(meta["shape"])
        return mask[0] if squeeze else mask

    def _cmd(self, cmd: str) -> dict:
        self.sock.send_multipart([json.dumps({"cmd": cmd}).encode()])
        return json.loads(self.sock.recv_multipart()[0])

    def stats(self) -> dict:
        return self._cmd("stats")

    def close_server(self) -> dict:
        return self._cmd("close")

    def close(self) -> None:
        self.sock.close(0)
