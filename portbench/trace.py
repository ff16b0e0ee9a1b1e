"""A profiled stretch of a run, reduced to what the per-layer metrics read.

``Stretch`` starts and stops ``torch.profiler`` around a steady part of
the window (never the whole window, and no trace is written to disk),
and ``reduce`` turns the device events into:

- ``busy_s``: the union of the intervals in which an operation ran on
  the device; ``window_s``: the stretch's length by the host clock.
- ``port_s`` and ``other_s``: device seconds in the program's own
  kernels (the ``__global__`` functions of its ``csrc/``) and in all
  other device operations.
- ``device_ops``: the ten device operations that took most time;
  ``idle_gaps``: idle device time by what the host was doing when the
  gap began (the innermost host event spanning it), ten labels at most.
"""
from __future__ import annotations

import glob
import os
import re
import time
from collections import defaultdict

import numpy as np
import torch

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(?:void\s+)?(\w+)\s*\(")
GAPS_LABELLED = 500


def port_kernels(package_dir: str) -> set:
    """Names of the ``__global__`` functions in the program's CUDA
    sources."""
    names = set()
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu*")):
        with open(path) as f:
            names |= set(_GLOBAL.findall(f.read()))
    return names


def kernel_base(name: str) -> str:
    """The function name behind a demangled kernel name."""
    path = name.replace("(anonymous namespace)::", "")
    path = path[5:] if path.startswith("void ") else path
    return re.split(r"[(<]", path, maxsplit=1)[0].rsplit("::", 1)[-1]


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


class Stretch:
    """One profiled stretch: ``start()``, ``stop()`` (after the device
    finished the stretch's work), then ``reduce``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t_start = self.t_stop = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the tracer, which takes seconds."""
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self.t_start = time.monotonic()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_stop = time.monotonic()
        self.prof.stop()

    @property
    def on(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def reduce(self, port_names: set) -> dict:
        host, dev = [], []
        for e in self.prof.profiler.kineto_results.events():
            row = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            (host if e.device_type() == torch.autograd.DeviceType.CPU
             else dev).append(row)
        out = {"t_start": self.t_start, "t_stop": self.t_stop,
               "window_s": self.t_stop - self.t_start, "busy_s": 0.0,
               "port_s": 0.0, "other_s": 0.0, "device_ops": [],
               "idle_gaps": [], "kernels": 0}
        if not dev:
            return out
        dev.sort()
        by_name = defaultdict(float)
        for a, b, name in dev:
            s = (b - a) * 1e-9
            by_name[name] += s
            out["port_s" if kernel_base(name) in port_names
                else "other_s"] += s
        out["kernels"] = len(dev)
        out["device_ops"] = [[_short(k), v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        # the union of the busy intervals, and the gaps between them
        gaps, busy = [], 0
        end = dev[0][0]
        cur_a = dev[0][0]
        for a, b, _ in dev:
            if a > end:
                busy += end - cur_a
                gaps.append((a - end, end))
                cur_a = a
            end = max(end, b)
        busy += end - cur_a
        out["busy_s"] = busy * 1e-9
        out["idle_gaps"] = _label_gaps(gaps, host)
        return out


def _label_gaps(gaps: list, host: list) -> list:
    """Idle seconds by the innermost host event spanning each gap's
    start, for the longest gaps; the rest summed under one label."""
    gaps.sort(reverse=True)
    by_label = defaultdict(float)
    if host:
        starts = np.array([h[0] for h in host], dtype=np.int64)
        ends = np.array([h[1] for h in host], dtype=np.int64)
        lengths = ends - starts
    for length, at in gaps[:GAPS_LABELLED]:
        label = "no host event recorded"
        if host:
            inside = np.nonzero((starts <= at) & (ends > at))[0]
            if len(inside):
                label = host[inside[np.argmin(lengths[inside])]][2]
        by_label[_short(label)] += length * 1e-9
    rest = sum(g for g, _ in gaps[GAPS_LABELLED:])
    if rest:
        by_label[f"gaps shorter than the {GAPS_LABELLED} longest"] += \
            rest * 1e-9
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:10]]
