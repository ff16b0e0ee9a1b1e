#!/usr/bin/env python3
"""Find the knee of an open-loop serving cell on the chip: one set-up,
then a window of ``--seconds`` at each of ``--rates`` (requests a
second), one JSON line each:

    python3 portbench/sweep.py --workload fcd67.serve_fleet --seed 5 \
        --seconds 5 --rates 1600 2000 2400 2800 3200

The knee is the highest rate at which at least 99% of the offered frames
are replied within the window and the 95th percentile of latency stays
under ``--p95_ms`` (100 ms: three frame periods of a 30 fps camera). The
cell's traffic file holds 0.8 of it, as a number. The benchmark's runs
do not run this.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--p95_ms", type=float, default=100.0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    config = harness.find(bench["configs"], cell["config"], "configuration")
    cfg = harness.read_json(os.path.join(harness.ROOT, config["file"]))
    traffic = harness.read_json(os.path.join(HERE, "traffic",
                                             f"{cell['traffic']}.json"))
    ctx = harness.Ctx(cell, cfg, traffic, args.seed, args.seconds, False,
                      "cuda", {})
    c = harness.driver(traffic["kind"]).Cell(ctx)
    c.setup()
    gc.collect()
    gc.freeze()  # as harness.run does
    knee = None
    for rate in args.rates:
        res = c.window(time.monotonic(), rate=rate)
        rec, m = res["rec"], res["metrics"]
        offered = rate * args.seconds * traffic["frames_per_request"]
        share = rec["frames_in_window"] / offered
        held = share >= 0.99 and m["serve_p95_ms"] < args.p95_ms \
            and res["failed"] == 0
        knee = rate if held else knee
        s = rec["engine"]
        print(json.dumps({"rate_per_s": rate, **m,
                          "replied_share": share, "failed": res["failed"],
                          "mean_batch": s["frames"] / max(s["batches"], 1),
                          "send_late_ms_max": max(rec["send_late_ms"]),
                          "gc": rec["gc"],
                          "held": held}), flush=True)
    print(json.dumps({"knee_per_s": knee,
                      "cell_rate_per_s": None if knee is None
                      else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
