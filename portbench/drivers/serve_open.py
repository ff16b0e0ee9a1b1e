"""An open loop: requests of ``frames_per_request`` frames at Poisson
arrivals of ``rate_per_s`` requests a second, each due at its time
whatever the replies do.

Every seed gets the same set of gaps (drawn once from ``gap_seed`` and
scaled to span the window exactly) in its own order, and its own frames
from the pool, so every run offers the same number of requests. The
generator sleeps until each request is due; how late it sent is
recorded. Latency runs from the due time.
"""
from __future__ import annotations

import time

import numpy as np

from .. import inputs
from ..engine_load import Request, ServeCell


def schedule(rate: float, seconds: float, gap_seed: int, seed: int
             ) -> np.ndarray:
    """Due times in [0, seconds] of round(rate * seconds) requests."""
    n = max(1, round(rate * seconds))
    gaps = np.random.default_rng(gap_seed).exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()
    order = np.random.default_rng(inputs.sub_seed(seed, "gaps"))
    return np.cumsum(order.permutation(gaps))


class Cell(ServeCell):
    def window(self, t_open: float, rate: float | None = None) -> dict:
        tr = self.tr
        rate = tr["rate_per_s"] if rate is None else rate
        seconds = self.ctx.seconds
        due = t_open + schedule(rate, seconds, tr["gap_seed"], self.ctx.seed)
        k = tr["frames_per_request"]
        rng = np.random.default_rng(inputs.sub_seed(self.ctx.seed, "frames"))
        first = rng.integers(0, tr["pool_frames"] - k + 1, len(due))
        # the sample that check compares, drawn before the window
        keep = np.zeros(len(due), bool)
        keep[rng.permutation(len(due))[:-(-tr["checked_frames"] // k)]] = True
        self.open(t_open)
        for t, f, kp in zip(due, first, keep):
            now = time.monotonic()
            self.tick(now)
            if t > now:
                time.sleep(t - now)
            self.submit(Request(int(f), k, float(t), bool(kp)))
        return self.finish(t_open, t_open + seconds, "due")
