"""What every cell shares: the cell's files found by name, the run's
context, the driver's life cycle, the per-layer readers, and the result
line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix's ``kind`` names its
driver (``drivers/<kind>.py``), and each per-layer metric has its reader
(``metrics/<name>.py``). Adding a cell, a mix, a driver or a metric adds
files and entries; no file here changes.

A driver module defines ``Cell(ctx)`` with ``setup()``, ``window(t_open)``
(returns ``{"metrics", "attempted", "failed", "rec"}``), ``release()``
(frees the program's state) and ``check()`` (the numbers compared with
the reference).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "sim2real_lane_segment_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "sim2real_lane_segment_tpu")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def driver(kind: str):
    """``portbench/drivers/<kind>.py``."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(name: str):
    """``portbench/metrics/<name>.py`` (a metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def nearest_rank(values, q: float) -> float:
    """The q-th percentile by nearest rank (inf counts as the largest)."""
    if not values:
        return math.inf
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def power_limit_w(index: int):
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


class Ctx:
    """One run: the cell, its configuration and traffic, the seed, the
    window, whether it is traced, the device, the limits and, for the
    harness's own tests, faults planted in the program."""

    def __init__(self, cell: dict, cfg: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, limits: dict,
                 faults=(), t_process: float | None = None):
        import torch

        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.limits, self.faults = limits, set(faults)
        self.t_process = time.monotonic() if t_process is None else t_process


def run(ctx: Ctx, bench: dict) -> dict:
    """One run of a cell: set-up, window, release, check; the result."""
    import torch

    from .reference import compare

    cell = driver(ctx.traffic["kind"]).Cell(ctx)
    cell.setup()
    # set-up's objects out of the collector's reach: a full collection
    # over them paused the host for 160-180 ms on an H100 host, and the
    # open loop's generator with it
    gc.collect()
    gc.freeze()
    t_open = time.monotonic()
    setup_s = t_open - ctx.t_process
    res = cell.window(t_open)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    trace = res["rec"].get("trace")
    cell.release()
    numbers = cell.check()
    correct = compare.judge(numbers, ctx.limits) and res["failed"] == 0

    name = ctx.cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    values = {}
    if ctx.trace:  # a per-layer metric without workloads: every cell
        for m in bench["per_layer"]:  # that reports what it moves
            mine = m.get("workloads",
                         [name] if m["moves"] in {e["name"] for e in e2e}
                         else [])
            v = reader(m["name"]).read(res["rec"]) if name in mine else None
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" else \
                res["metrics"][m["name"]]
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    index = ctx.device.index if ctx.device.index is not None else 0
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(index) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit_w(index) if cuda else None}
    line = {"correct": bool(correct), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": values, "device": device}
    if ctx.trace and trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = {k: {"value": numbers[k], "limit": ctx.limits.get(k)}
                      for k in numbers}
    line["checks"]["failed_requests_or_steps"] = {"value": res["failed"],
                                                  "limit": 0}
    return line
