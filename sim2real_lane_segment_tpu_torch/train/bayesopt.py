"""Sequential model-based search for the HPO sweep (``cli/tune.py``).

The port's own copy of the JAX package's ``train/bayesopt.py`` (numpy
only): the same proposals for the same seed and observations, bit for
bit (``tests/test_torch_tune.py``).

The reference paired Ray's BayesOptSearch with ASHA (tune.py:69-76).
Ray isn't a dependency here, so this is a small self-contained
Tree-structured Parzen Estimator (TPE, Bergstra et al. 2011): after a
random warm-up, observations are split into a good quantile and the
rest; per-dimension Gaussian kernel densities l(x) (good) and g(x)
(bad) are fit, candidates are drawn from l and ranked by the expected-
improvement surrogate l(x)/g(x).  Like BayesOpt it concentrates search
near promising regions while the ASHA rungs kill weak trials early.
"""
from __future__ import annotations

import math

import numpy as np


class TPEProposer:
    """Propose/observe interface over a box-bounded continuous space.

    space: {name: (low, high)}; maximizes the observed score.
    """

    def __init__(self, space: dict[str, tuple[float, float]], *,
                 seed: int = 0, n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 32):
        self.space = dict(space)
        self.names = sorted(space)
        self.lo = np.array([space[n][0] for n in self.names])
        self.hi = np.array([space[n][1] for n in self.names])
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.xs: list[np.ndarray] = []
        self.ys: list[float] = []

    # -- internals ----------------------------------------------------------

    def _uniform(self) -> np.ndarray:
        return self.rng.uniform(self.lo, self.hi)

    def _kde_logpdf(self, pts: np.ndarray, x: np.ndarray) -> float:
        """Sum over dims of a 1-d Gaussian-mixture log density."""
        n = len(pts)
        # Scott-style bandwidth per dim, floored to 1/20 of the range so a
        # tight cluster can't collapse the kernel to a delta
        bw = np.maximum(pts.std(axis=0) * n ** (-0.2), (self.hi - self.lo) / 20)
        z = (x[None, :] - pts) / bw[None, :]
        ll = 0.0
        for d in range(pts.shape[1]):
            comp = -0.5 * z[:, d] ** 2 - math.log(bw[d]) \
                - 0.5 * math.log(2 * math.pi)
            m = comp.max()
            ll += m + math.log(np.exp(comp - m).sum() / n)
        return float(ll)

    # -- API ----------------------------------------------------------------

    def propose(self) -> dict:
        if len(self.xs) < self.n_startup:
            x = self._uniform()
            return dict(zip(self.names, x.tolist()))

        xs = np.stack(self.xs)
        ys = np.asarray(self.ys)
        n_good = max(2, int(math.ceil(self.gamma * len(ys))))
        order = np.argsort(-ys)           # maximize
        good, bad = xs[order[:n_good]], xs[order[n_good:]]
        if len(bad) < 2:
            x = self._uniform()
            return dict(zip(self.names, x.tolist()))

        bw = np.maximum(good.std(axis=0) * len(good) ** (-0.2),
                        (self.hi - self.lo) / 20)
        best_x, best_score = None, -np.inf
        for _ in range(self.n_candidates):
            center = good[self.rng.integers(len(good))]
            cand = np.clip(center + self.rng.normal(0, bw), self.lo, self.hi)
            score = self._kde_logpdf(good, cand) - self._kde_logpdf(bad, cand)
            if score > best_score:
                best_x, best_score = cand, score
        return dict(zip(self.names, best_x.tolist()))

    def observe(self, config: dict, score: float) -> None:
        self.xs.append(np.array([config[n] for n in self.names]))
        self.ys.append(float(score))


class RandomProposer:
    """Uniform sampling with the same propose/observe interface."""

    def __init__(self, space: dict[str, tuple[float, float]], *, seed: int = 0):
        self.space = dict(space)
        self.names = sorted(space)
        self.rng = np.random.default_rng(seed)

    def propose(self) -> dict:
        return {n: float(self.rng.uniform(*self.space[n])) for n in self.names}

    def observe(self, config: dict, score: float) -> None:
        pass


def make_proposer(kind: str, space, *, seed: int = 0):
    if kind == "tpe":
        return TPEProposer(space, seed=seed)
    if kind == "random":
        return RandomProposer(space, seed=seed)
    raise ValueError(f"unknown search kind {kind!r}")
