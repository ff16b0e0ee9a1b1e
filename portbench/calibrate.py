#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one
cell, at the cell's own size, in one process:

    python3 portbench/calibrate.py --workload fcd67.train_sup \
        --seeds 101 102 ... --control 3 --faults 3 [--seconds 3]

- ``program``: every seed's numbers from a sound run (training: set-up
  and the checked steps; serving: set-up and a short window at the
  cell's own load), against the reference;
- ``control``: on the first ``--control`` seeds, the reference computed
  with float8 convolutions (``reference/lowp.py``) put in the program's
  place, against the float32 reference;
- ``fault``: on the first ``--faults`` seeds, the program with each fault
  of ``faults.py`` that the cell can have planted.

One JSON line a reading. The benchmark's runs do not run this. The
limits of ``correct`` are set from these readings, above the program's
and below the control's or a fault's, and written to
``reference/limits/<config>.json`` with the readings each came from.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from portbench import faults, harness
    from portbench.reference import compare
    from portbench.reference import train as ref
    from portbench.reference.lowp import Float8Convs

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    config = harness.find(bench["configs"], cell["config"], "configuration")
    cfg = harness.read_json(os.path.join(harness.ROOT, config["file"]))
    traffic = harness.read_json(os.path.join(HERE, "traffic",
                                             f"{cell['traffic']}.json"))
    train = traffic["kind"] == "train_scan"
    planted = faults.TRAIN if train else faults.SERVE

    def one(seed, fault=(), control=False):
        t0 = time.monotonic()
        ctx = harness.Ctx(cell, cfg, traffic, seed, args.seconds, False,
                          "cuda", {}, fault)
        c = harness.driver(traffic["kind"]).Cell(ctx)
        c.setup()
        if not train:
            c.window(time.monotonic())
        c.release()
        if train:
            want = c.reference()
            out = {"seed": seed,
                   "program": compare.train_numbers(c.prog, want),
                   "grad1_gap_all_leaves": compare.leaf_gap(c.prog["grad1"],
                                                            want["grad1"])}
            if control:
                out["control"] = compare.train_numbers(
                    c.reference(Float8Convs()), want)
        else:
            out = {"seed": seed, "program": c.check()}
            if control:
                frames, _ = c.sampled()
                want = ref.serve_logits(cfg, c.weights, frames)
                low = ref.serve_logits(cfg, c.weights, frames, Float8Convs())
                out["control"] = {"mask_gap": compare.mask_gap(
                    want, low.argmax(1))}
        out["seconds"] = time.monotonic() - t0
        del c
        torch.cuda.empty_cache()
        return out

    for i, seed in enumerate(args.seeds):
        r = one(seed, control=i < args.control)
        print(json.dumps({"workload": args.workload, "kind": "program", **r}),
              flush=True)
        for f in planted if i < args.faults else ():
            r = one(seed, fault=(f,))
            print(json.dumps({"workload": args.workload, "kind": "fault",
                              "fault": f, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
