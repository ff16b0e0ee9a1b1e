#!/usr/bin/env python3
"""The PyTorch port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload fcd67.train_sup --seed 7 \
        --seconds 10 --trace 0

Needs CUDA cards (as many as the cell's ``chips``); without them it
exits with code 2 and prints no result. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: every number compared with the reference beside its limit.
The same numbers are the last lines of standard error. A run that finds
JAX or the JAX package loaded once the window has closed exits with
code 3 and prints no result.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device=None, cfg=None, traffic=None, limits=None,
         faults=(), bench=None) -> int:
    """The command; the keywords are for the harness's own tests, which
    run it on the CPU at a small size, without looking for a card."""
    args = parse(argv)
    from portbench import harness
    from portbench.reference import compare

    bench = bench if bench is not None else harness.benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if device is None:
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                  f"this machine has {cards}", file=sys.stderr)
            return 2
        device = "cuda"
    config = harness.find(bench["configs"], cell["config"], "configuration")
    if cfg is None:
        cfg = harness.read_json(os.path.join(harness.ROOT, config["file"]))
    if traffic is None:
        traffic = harness.read_json(os.path.join(
            HERE, "traffic", f"{cell['traffic']}.json"))
    if limits is None:
        limits = compare.limits(cell["config"])
    ctx = harness.Ctx(cell, cfg, traffic, args.seed, args.seconds,
                      bool(args.trace), device, limits, faults, T_PROCESS)
    line = harness.run(ctx, bench)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
