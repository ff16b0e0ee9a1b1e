#!/usr/bin/env python3
"""The TransitionDown sites on the card, for one tree of the port: each
site of FCDenseNet67, 57 and 103 timed alone, serving's forward at B=64,
K1 with one tap and K2 at B=32, beside one cuDNN call on the activated
operands and the bound.

    python3 scripts/torch_td_timing.py [--root DIR] [--archs 67 57 103]
                                       [--check] [--vjp] [--e2e 67 57]

Needs one CUDA card.  ``--root`` names the directory that holds the
``sim2real_lane_segment_tpu_torch`` package to time (default: this
checkout), so that two trees can be timed in turns on one card, an older
one unpacked under ``build/`` with ``git archive``; the kernels build into
that tree's own ``build/``.  The harness is ``chip_smoke.td_time_sites``:
device time alone, CUDA events around 20 calls that the host queued
behind a spin kernel holding the stream.  ``--check`` first holds every
site against its plain version at B=32 (``chip_smoke.td_check_sites``,
routes printed, not required).  ``--vjp`` also re-reads
``cli.train_breakdown``'s five TransitionDown rows of FCDenseNet67 at
B=128 (its ``_time_scan``, floor subtracted): the forward (K1) and the
vector-Jacobian product of ``sum(out**2)``, and beside them K2 alone on
the VJP's cotangent (held), so that the VJP splits into K1, K2 and
autograd's share.  ``--e2e`` times the paths around them per arch: the
B=64 fused forward (seeded weights, ``fused_apply``; CUDA events around
10 calls as ``chip_smoke._time_ms`` times it, and device time alone by
``_held_ms``) and the graphed B=32 ``--pallas_train`` step
(``cli.train_benchmark.measure``: 3 replays of 20 steps).  The last line
is one JSON object: per arch and wrapper the site rows (plane, C, N, ms,
cuDNN ms, bound ms, GB), with the card's name and power limit.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VJP_BATCH = 128


def vjp_split(cs, device, card) -> list:
    """``cli.train_breakdown``'s TransitionDown rows of FCDenseNet67 at
    B=128, with K2 alone beside them."""
    import numpy as np
    import torch

    from sim2real_lane_segment_tpu_torch.cli import train_breakdown as tb
    from sim2real_lane_segment_tpu_torch.cli.serve_breakdown import (
        _time_scan, build)
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.models import \
        tiramisu_train_fused as ttf
    from sim2real_lane_segment_tpu_torch.models.tiramisu import drop_masks

    model = build("67", device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (VJP_BATCH, 3, tb.HEIGHT, tb.WIDTH)).astype(np.float32)).to(device)
    masks = drop_masks(torch.Generator().manual_seed(1), model, VJP_BATCH,
                       device)
    calls = []
    real = ttf.Consumer.apply

    def recorder(*a):
        calls.append(tuple(t.detach() for t in a))
        return real(*a)

    with torch.no_grad():
        ttf.fused_apply_train(model, x, masks, use_softmax=False,
                              consumer_fn=recorder)

    def fwd(*a):
        with torch.no_grad():
            return real(*a)

    def vjp(*a):
        with torch.enable_grad():
            leaves = [t.requires_grad_() for t in (t.detach()
                                                    for t in a[:5])]
            out = real(*leaves, a[5])
            s = (out.to(torch.float32) ** 2).sum()
            return (s.detach(), *torch.autograd.grad(s, leaves))

    rows = []
    timing = dict(k=tb.K, iters=tb.ITERS, with_floor=True)
    for a in calls:
        dt_f, fl_f = _time_scan(fwd, a, **timing)
        dt_b, fl_b = _time_scan(vjp, a, **timing)
        with torch.no_grad():
            dy = (2 * real(*a).float()).to(a[0].dtype)
        k2 = cs._held_ms(lambda: ktb.consumer_bwd(a[0], a[1], a[2], a[3],
                                                  a[5], dy))
        c, _, n = a[3].shape
        row = {"plane": f"{a[0].shape[2]}x{a[0].shape[3]}", "c": c, "n": n,
               "fwd_ms": max(dt_f - fl_f, 1e-9) * 1e3,
               "vjp_ms": max(dt_b - fl_b, 1e-9) * 1e3, "k2_ms": k2}
        row["rest_ms"] = row["vjp_ms"] - row["fwd_ms"] - k2
        rows.append(row)
        print(f"  vjp B={VJP_BATCH} {row['plane']} C={c}: fwd (K1) "
              f"{row['fwd_ms']:.4f} ms, VJP {row['vjp_ms']:.4f} ms = K1 + K2 "
              f"{k2:.4f} ms + autograd's sum(out**2) and casts "
              f"{row['rest_ms']:.4f} ms  [{card}]", flush=True)
    print(f"vjp: five TD VJPs {sum(r['vjp_ms'] for r in rows):.4f} ms, K1 "
          f"{sum(r['fwd_ms'] for r in rows):.4f}, K2 "
          f"{sum(r['k2_ms'] for r in rows):.4f}  [{card}]", flush=True)
    return rows


def end_to_end(cs, arch, device, card) -> dict:
    """The B=64 fused forward and the graphed B=32 step of ``arch``."""
    import numpy as np
    import torch

    from sim2real_lane_segment_tpu_torch.cli import train_benchmark
    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import (
        fold_model, fused_apply)

    model = cs.make_model(cs.seeded_state_dict(device, arch), DEFAULT_POLICY,
                          device, arch)
    folded = fold_model(model)
    x = cs.model_input(cs.synthetic_frames(np.random.default_rng(cs.SEED + 3),
                                           cs.TIME_BATCH), device)
    with torch.no_grad():
        def fwd():
            return fused_apply(model, x, folded, use_softmax=False)
        events = cs._time_ms(fwd)
        held = cs._held_ms(fwd, 10)
    del model, folded, x
    step = train_benchmark.measure(arch, cs.TRAIN_BATCH, 20, 3,
                                   pallas_train=True, device=device)
    row = {"forward_ms": events, "forward_held_ms": held,
           "step_ms": step["step_ms"]}
    print(f"e2e: FCDenseNet{arch} B={cs.TIME_BATCH} fused forward {events:.3f} "
          f"ms (events), {held:.3f} ms (held); graphed B={cs.TRAIN_BATCH} "
          f"--pallas_train step {step['step_ms']:.3f} ms  [{card}]",
          flush=True)
    return row


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE,
                   help="the directory holding the package to time")
    p.add_argument("--archs", nargs="+", default=["67", "57", "103"],
                   choices=["67", "57", "103"])
    p.add_argument("--check", action="store_true",
                   help="hold every site against its plain version first")
    p.add_argument("--vjp", action="store_true",
                   help="split train_breakdown's TD VJPs at B=128")
    p.add_argument("--e2e", nargs="*", default=[], choices=["67", "57", "103"],
                   help="time the fused forward and graphed step of these")
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
    out = {"root": os.path.abspath(args.root), "card": card, "sites": {}}
    if args.check:
        for arch in args.archs:
            cs.td_check_sites(arch, device, card, require_mma=False)
    for arch in args.archs:
        rows = cs.td_time_sites(arch, device, card)
        out["sites"][arch] = rows
        print(f"td: FCDenseNet{arch} summed over its five sites: " + "; ".join(
            f"{cs.TD_NAMES[k]} kernel {sum(r['ms'] for r in v):.4f} ms, "
            f"cuDNN {sum(r['library_ms'] for r in v):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in v):.4f} ms"
            for k, v in rows.items()) + f"  [{card}]", flush=True)
    if args.vjp:
        out["vjp"] = vjp_split(cs, device, card)
    out["e2e"] = {arch: end_to_end(cs, arch, device, card)
                  for arch in args.e2e}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
