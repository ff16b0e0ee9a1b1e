"""A whole train step captured once as a CUDA graph and replayed.

The counterpart of one ``lax.scan`` dispatch of the JAX package's
``train_steps_scan``: there XLA runs K steps as one program; here every
step is one ``torch.cuda.CUDAGraph.replay()`` of the step the trainer
captured, so the host pays one launch a step instead of the thousands of
eager launches and the Python of the autograd Functions.

``StepGraph(body, state)``: ``body()`` runs one step on static buffers
(the trainer's index vectors, draws and masks) and returns its logs as
one tensor; ``state`` lists every tensor the step writes in place
(parameters, running statistics, optimizer state).  PyTorch's
whole-network capture needs warm-up steps on a side stream first (they
start cuBLAS, cuDNN and the autograd engine's device thread, and fill
the port's constant caches); they run on the real state, which is then
restored from a copy, so only replays train.  A failed capture raises:
there is no quiet retreat to the eager step.

``replays`` and ``captures`` count, process-wide, the replays and the
captures since ``reset_counts``: a replay runs no Python, so the kernel
wrappers' launch counters move at the capture only.  ``StepGraph``'s
construction is one ``train.capture`` span (``core.tracing``), its eager
warm-up steps one ``train.warmup`` inside it.  ``StepGraph(body, state,
counters)`` also reads ``counters()``, a dict of counts that the body's
launches move, before and after the capture: what the captured step
moved goes on the span as attributes and into ``counted``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.tracing import span

counts = {"captures": 0, "replays": 0}

WARMUP_STEPS = 2


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


class StepGraph:
    """One captured step: ``replay()`` runs it and returns its logs."""

    def __init__(self, body: Callable[[], torch.Tensor],
                 state: Sequence[torch.Tensor],
                 counters: Callable[[], dict] = dict):
        with span("train.capture") as s:
            self._capture(body, state, counters)
            s.attrs.update(self.counted)

    def _capture(self, body, state, counters) -> None:
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), span("train.warmup"):
            for _ in range(WARMUP_STEPS):
                body()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved, strict=True):
                t.copy_(s)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        # the capture empties the allocator's cache first; emptied here,
        # what the card reserves during the capture is the graph's pool
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = counters()
        try:
            with torch.cuda.graph(self.graph):
                self.out = body()
        except Exception as e:
            raise RuntimeError(f"capturing the train step as a CUDA graph "
                               f"failed: {e}") from e
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.counted = {k: v - before[k] for k, v in counters().items()}
        counts["captures"] += 1

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        counts["replays"] += 1
        return self.out
