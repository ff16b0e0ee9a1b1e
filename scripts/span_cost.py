#!/usr/bin/env python3
"""What a program span (``core/tracing``) costs the host.

    python3 scripts/span_cost.py [--n 200000] [--reps 2]

Times ``--n`` spans in a loop, ``--reps`` times each: an empty loop, a
top-level span, a span inside an open one, and a span while a CPU
``torch.profiler`` runs (mirrored as a profiler event). Prints one line
``SPANCOST {...}``: microseconds a span for each, less the empty loop's
microseconds an iteration, and the ring's size and spans closed so far.
Runs on the host alone; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loop(n: int, span=None) -> float:
    t0 = time.perf_counter()
    if span is None:
        for _ in range(n):
            pass
    else:
        for _ in range(n):
            with span("cost.span"):
                pass
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sim2real_lane_segment_tpu_torch.core import tracing

    out = {"empty_loop_us": [], "top_us": [], "nested_us": [],
           "mirrored_us": []}
    for _ in range(args.reps):
        empty = _loop(args.n)
        out["empty_loop_us"].append(empty)
        out["top_us"].append(_loop(args.n, tracing.span) - empty)
        with tracing.span("cost.outer"):
            out["nested_us"].append(_loop(args.n, tracing.span) - empty)
        with profile(activities=[ProfilerActivity.CPU]):
            torch.zeros(1).add_(1)
            out["mirrored_us"].append(_loop(args.n, tracing.span) - empty)
    held = tracing.spans()
    out["ring"] = [len(held), held[-1].seq if held else 0]
    print("SPANCOST", json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
