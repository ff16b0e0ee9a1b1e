"""A closed loop: ``clients`` clients, each sending a request of
``frames_per_request`` consecutive frames of the pool (a chunk of a
recording) and the next one when the reply has come, until the window's
seconds are over. Latency runs from the send.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .. import inputs
from ..engine_load import Request, ServeCell


class Cell(ServeCell):
    def window(self, t_open: float) -> dict:
        tr, seconds = self.tr, self.ctx.seconds
        t_close = t_open + seconds
        k = tr["frames_per_request"]
        self.open(t_open)
        lock = threading.Lock()

        def client(c: int) -> None:
            rng = np.random.default_rng(
                inputs.sub_seed(self.ctx.seed, f"client{c}"))
            while time.monotonic() < t_close:
                r = Request(int(rng.integers(0, tr["pool_frames"] - k + 1)),
                            k, time.monotonic())
                with lock:
                    self.submit(r)
                    pending = r.pending
                pending.event.wait(tr["reply_wait_s"])
                if pending.error is not None or not pending.event.is_set():
                    return

        threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                    name=f"portbench-client{c}")
                   for c in range(tr["clients"])]
        for t in threads:
            t.start()
        if self.stretch is not None:  # sleep to the stretch's ends
            a, length = self.profile_at
            time.sleep(max(0.0, a - time.monotonic()))
            self.tick(time.monotonic())
            time.sleep(length)
            self.tick(time.monotonic())
        for t in threads:
            t.join(tr["reply_wait_s"] + 10.0)
        return self.finish(t_open, t_close, "sent")
