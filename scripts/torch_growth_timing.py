#!/usr/bin/env python3
"""FCDenseNet57's growth-12 dense layers on the card, for one tree of the
port: K4's dense layers per B=64 forward and K1 (3x3 apart), K2, K3a and
K3b per B=32 ``--pallas_train`` step.

    python3 scripts/torch_growth_timing.py [--root DIR] [--arch 57]

Needs one CUDA card.  ``--root`` names the directory that holds the
``sim2real_lane_segment_tpu_torch`` package to time (default: this
checkout), so that two trees can be timed in turns on one card, an older
one unpacked under ``build/`` with ``git archive``; the kernels build into
that tree's own ``build/``.  The harness is ``chip_smoke.growth_timing``
(phase 25d), with the weights from its seed: each dense layer and train
site is held against its plain version, then timed alone by CUDA events
beside its plain version and one cuDNN call on the activated operands.
The last line is one JSON object: per kernel its ms, plain ms, cuDNN ms,
bound ms, launches and those on the tensor cores, with the card's name
and power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE,
                   help="the directory holding the package to time")
    p.add_argument("--arch", default="57", choices=["57", "67", "103"])
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    # the harness from this checkout, whichever tree --root names
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from sim2real_lane_segment_tpu_torch.core.runtime import \
        set_float32_precision
    import sim2real_lane_segment_tpu_torch as pkg

    cs.check(torch.cuda.is_available(), "this script needs a CUDA card")
    set_float32_precision()
    card = cs.card_label()
    device = torch.device("cuda")
    print(f"package {os.path.dirname(pkg.__file__)}  [{card}]", flush=True)
    sd = cs.seeded_state_dict(device, args.arch)
    timed, k1_3x3 = cs.growth_timing(sd, device, card, args.arch)
    rows = {}
    for name, d in {**timed, "consumer_fwd_3x3": k1_3x3}.items():
        rows[name] = {
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "library_ms": d["library_ms"],
            "bound_ms": max(d["bytes"] / cs.PEAK_BYTES,
                            d["ops"] / cs.PEAK_BF16_OPS) * 1e3,
            "launches": d["calls"], "mma": d["mma"]}
    print(json.dumps({"root": os.path.abspath(args.root), "arch": args.arch,
                      "card": card, "kernels": rows}))


if __name__ == "__main__":
    main()
