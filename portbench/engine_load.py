"""Serving through the program's ``BatchingEngine``, driven in-process.

Set-up makes the seed's weights and writes them as a checkpoint under
``TMPDIR``, builds the predictor as ``cli.serve`` does
(``build_predict_fn`` with ``--arch <config> --fused``), starts the
engine with the traffic's ``max_batch`` and ``max_wait_ms`` and sends
every batch shape the traffic can make through it once (the first call
also folds the weights), and makes the pool of frames on the device and
copies it to the host. The benchmark wraps the predictor to record each
batch's span: its start, its end and its padded size.

A request's latency runs from its due time (open loop) or its send
(closed loop) to the moment its reply is set. Replies are awaited in
submission order by one thread; the engine replies in that order. After
the window closes, replies still due are awaited up to ``reply_wait_s``;
one that never comes or carries an error has failed.

``check`` takes a sample of the replied frames, drawn from the seed, and
compares their served masks with the reference's logits.
"""
from __future__ import annotations

import gc
import importlib
import os
import queue
import tempfile
import threading
import time

import numpy as np
import torch

from . import faults, inputs
from .harness import PORT, nearest_rank
from .reference import compare
from .reference import train as ref
from .trace import Stretch, port_kernels


def buckets(sizes, max_batch: int) -> list[int]:
    """The padded batch shapes (the engine's power-of-two buckets) that
    requests of ``sizes`` frames can make."""
    b = 1
    while b < min(sizes):
        b *= 2
    out = []
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


class Request:
    """One request; once replied it keeps its mask only if ``keep`` (the
    sample that ``check`` compares), so the window retains little."""

    __slots__ = ("first", "count", "due", "sent", "replied", "pending",
                 "ok", "keep", "result")

    def __init__(self, first: int, count: int, due: float,
                 keep: bool = True):
        self.first, self.count, self.due = first, count, due
        self.sent = self.replied = None
        self.pending = self.result = None
        self.ok, self.keep = False, keep


class Replies:
    """One thread that waits for each submitted request, in order, and
    stamps its reply time."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="portbench-replies")
        self.thread.start()

    def add(self, r: Request) -> None:
        self.q.put(r)

    def _run(self) -> None:
        while True:
            r = self.q.get()
            if r is None:
                return
            r.pending.event.wait()
            r.replied = time.monotonic()
            r.ok = r.pending.error is None and r.pending.result is not None
            r.result = r.pending.result if r.keep else None
            r.pending = None

    def close(self, deadline: float) -> None:
        self.q.put(None)
        self.thread.join(max(0.0, deadline - time.monotonic()))


class GcWatch:
    """The garbage collector's pauses while a window runs."""

    def __init__(self):
        self.pauses, self._t = [], None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.monotonic()
        elif self._t is not None:
            self.pauses.append((info["generation"],
                                time.monotonic() - self._t))

    def close(self) -> dict:
        gc.callbacks.remove(self._cb)
        gen2 = [d for g, d in self.pauses if g == 2]
        return {"count": len(self.pauses), "gen2": len(gen2),
                "max_ms": 1e3 * max((d for _, d in self.pauses), default=0),
                "total_ms": 1e3 * sum(d for _, d in self.pauses)}


class ServeCell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.cfg, ctx.traffic
        self.device = ctx.device

    def setup(self) -> None:
        serve = importlib.import_module(f"{PORT}.cli.serve")
        serving = importlib.import_module(f"{PORT}.serving")
        self.package_dir = importlib.import_module(PORT).__path__[0]
        cfg, tr, dev, seed = self.cfg, self.tr, self.device, self.ctx.seed
        h, w = cfg["height"], cfg["width"]
        self.weights = inputs.weights(cfg, seed, dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "weights.pt")
            torch.save({k: v.cpu() for k, v in self.weights.items()}, path)
            args = serve.parse_args([
                "--checkpointPath", path, "--arch", cfg["arch"], "--fused",
                "--num_cls", str(cfg["n_classes"]), "--height", str(h),
                "--width", str(w)])
            predict, _, _ = serve.build_predict_fn(args, device=dev)
        predict = faults.plant_serve(self.ctx.faults, predict,
                                     cfg["n_classes"])
        self.stretch = Stretch(dev) if self.ctx.trace else None
        if self.stretch is not None:
            self.stretch.warm()
        self.batches = []   # (start, end, padded frames)

        def recorded(frames):
            t0 = time.monotonic()
            out = predict(frames)
            self.batches.append((t0, time.monotonic(), len(frames)))
            return out

        self.engine = serving.BatchingEngine(
            recorded, height=h, width=w, max_batch=tr["max_batch"],
            max_wait_ms=tr["max_wait_ms"])
        # every bucket once, through the engine's own thread: its first
        # forward makes that thread's cuDNN and cuBLAS state
        for b in buckets([tr["frames_per_request"]], tr["max_batch"]):
            self.engine.predict(np.zeros((b, h, w, 3), np.uint8))
        self.pool = inputs.frames(tr["pool_frames"], h, w, seed, "pool",
                                  dev).cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def open(self, t_open: float) -> None:
        """A fresh reply thread and record for a window opening at
        ``t_open`` (the engine is set-up's); the profiled stretch (traced
        runs) from 0.6 of the window for 0.3 of it, 3 s at most."""
        self.batches.clear()
        self.stats0 = dict(self.engine.stats)
        self.requests: list[Request] = []
        self.replies = Replies()
        self.gc = GcWatch()
        a = t_open + 0.6 * self.ctx.seconds
        self.profile_at = (a, min(3.0, 0.3 * self.ctx.seconds))

    def tick(self, now: float) -> None:
        """Start or stop the profiled stretch when it is due (called by
        the window's own thread)."""
        st = self.stretch
        if st is None or st.t_stop is not None:
            return
        if st.prof is None and now >= self.profile_at[0]:
            st.start()
        elif st.on and now >= st.t_start + self.profile_at[1]:
            st.stop()

    def frames_of(self, r: Request) -> np.ndarray:
        return self.pool[r.first:r.first + r.count]

    def submit(self, r: Request) -> None:
        r.sent = time.monotonic()
        r.pending = self.engine.submit(self.frames_of(r))
        self.requests.append(r)
        self.replies.add(r)

    def finish(self, t_open: float, t_close: float, origin: str) -> dict:
        """Await the replies and reduce the window."""
        self.replies.close(time.monotonic() + self.tr["reply_wait_s"])
        if self.stretch is not None and self.stretch.on:
            self.stretch.stop()
        seconds = t_close - t_open
        done = [r for r in self.requests if r.ok]
        failed = len(self.requests) - len(done)
        lat = [((r.replied - getattr(r, origin)) * 1e3) if r.ok
               else float("inf") for r in self.requests]
        in_window = sum(r.count for r in done if r.replied <= t_close)
        rec = {"kind": "serve", "cfg": self.cfg, "window_s": seconds,
               "origin": origin, "batches": list(self.batches),
               "requests": [(getattr(r, origin), r.replied, r.count)
                            for r in done],
               "frames_in_window": in_window,
               "engine": {k: v - self.stats0[k]
                          for k, v in self.engine.stats.items()},
               "send_late_ms": [(r.sent - r.due) * 1e3
                                for r in self.requests],
               "gc": self.gc.close()}
        if self.stretch is not None and self.stretch.prof is not None:
            rec["trace"] = self.stretch.reduce(
                port_kernels(self.package_dir))
        return {"metrics": {"serve_frames_per_s": in_window / seconds,
                            "serve_p95_ms": nearest_rank(lat, 95)},
                "attempted": len(self.requests), "failed": failed,
                "rec": rec}

    def release(self) -> None:
        rng = np.random.default_rng(inputs.sub_seed(self.ctx.seed, "check"))
        kept = [r for r in self.requests if r.ok and r.keep]
        want = self.tr["checked_frames"]
        picked, n = [], 0
        for i in rng.permutation(len(kept)):
            if n >= want:
                break
            picked.append(kept[int(i)])
            n += kept[int(i)].count
        self.sample = [(self.frames_of(r), r.result) for r in picked]
        self.engine.close()
        del self.engine, self.requests, self.replies
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sampled(self):
        """The sampled replies: their frames and served masks, on the
        device."""
        frames = np.concatenate([f for f, _ in self.sample])
        served = np.concatenate([m for _, m in self.sample])
        return (torch.from_numpy(frames).to(self.device),
                torch.from_numpy(served).to(self.device))

    def check(self) -> dict:
        if not self.sample:
            return {"mask_gap": float("nan")}
        frames, served = self.sampled()
        logits = ref.serve_logits(self.cfg, self.weights, frames)
        return {"mask_gap": compare.mask_gap(logits, served)}
