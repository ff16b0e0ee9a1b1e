"""Per-level breakdown and roofline of the fused FCDenseNet serving forward
(``models/tiramisu_fused.fused_apply``, kernel K4) on the card.

Counterpart of the JAX package's ``cli/serve_breakdown.py``:

    python -m sim2real_lane_segment_tpu_torch.cli.serve_breakdown --arch 67 -b 256
    python -m sim2real_lane_segment_tpu_torch.cli.serve_breakdown --ablate 120x160

Method: one real ``fused_apply`` forward records every dense block's
inputs through its ``block_fn`` hook; each recorded
``kernels.dense_block.dense_block`` call is then re-timed alone by
``_time_scan``, and so is the full forward, each with the harness's own
cost (its floor) subtracted.  For each level it prints the time beside the
level's FLOPs (the JAX formula: the 3x3 products, the TransitionDown's
1x1 and the classifier's) and the bytes the port's kernels move (the
virtual concat copied into the block's buffer; each layer reading c_j
channels and writing g; a TransitionDown reading and writing c_total; the
classifier reading c_total and writing 8 f32 logits; the weights once),
and its shares of the card's peaks (``--peak_tflops``, ``--peak_gbps``:
one H100's dense bf16 rate and HBM rate).  The gap between the sum of the
levels and the full forward (the median of three timed runs, whose
spread it also prints) is the glue between blocks (first conv, pools,
transposed convs).  Every printed time carries the card's name and
power limit.  ``--ablate SUBSTR`` also times the levels whose name holds
SUBSTR with their dense layers as the two diagnostic variants of the
tensor-core layer (``dense_layer(..., ablate=)``: the centre tap alone;
x without BN + ReLU), wrong math at the same launches; a level off that
route (float32, or a growth other than 12 or 16) is skipped with its
reason.

Runs on the card unless given ``--device cpu`` (or ``main(...,
device="cpu")``), where the times are the host's.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time

import numpy as np
import torch

from ..core import runtime
from . import common

# one H100 SXM: dense bf16 tensor-core rate and HBM rate (NVIDIA data sheet)
H100_PEAK_TFLOPS = 989.0
H100_PEAK_GBPS = 3350.0
FULL_RUNS = 3   # timed runs of the full forward: the median and the spread
HEIGHT, WIDTH = 120, 160   # the frames the JAX CLI times
K, ITERS = 8, 4            # calls a timed run, and runs (``_time_scan``)
# the hold put before a timed loop on the card (``_time_scan``): its first
# length, the longest it is stretched to, the tries, and the clock that turns
# seconds into spin cycles (no lower than one H100's top SM clock, 1.98 GHz,
# so a hold lasts at least as long as asked)
HOLD_S, HOLD_MAX_S, HOLD_TRIES, HOLD_CLOCK_HZ = 0.005, 0.5, 4, 2.0e9


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _consume(tree) -> torch.Tensor:
    """A position-weighted sum of the ``abs`` of every element of every
    tensor in ``tree``, as one f32 scalar: each row of a leaf (its first
    axis) summed and weighted by its position plus one.  A floating leaf
    is read once, by one reduction (no f32 copy of it is made)."""
    tot = None
    for leaf in _leaves(tree):
        a = leaf.detach()
        if not a.is_floating_point():
            a = a.to(torch.float32)
        if a.dim() <= 1:
            part = a.to(torch.float32).abs()
        else:
            part = torch.linalg.vector_norm(a, 1, dim=tuple(range(1, a.dim())),
                                            dtype=torch.float32)
        if part.dim() == 1:
            w = torch.arange(1, part.shape[0] + 1, dtype=torch.float32,
                             device=part.device)
            part = torch.dot(part, w)
        tot = part if tot is None else tot + part
    return tot


def _time_scan(fn, args, k=8, iters=4, with_floor=False):
    """Mean seconds per ``fn(*args)`` over ``k * iters`` calls; with
    ``with_floor``, ``(dt, floor)``.

    On a card the calls run back to back between two CUDA events, after
    one untimed call of the same loop body (which builds the kernels and
    sets up cuDNN).  The events time the device's work alone, as the JAX
    harness's scan does: a spin kernel (``torch.cuda._sleep``) holds the
    stream while the host queues the whole loop, so the host's launch cost
    and its jitter stay out of the reading.  Where the host was still
    queueing when the hold ended, the loop is run again behind a hold of
    twice the host's queueing time, up to ``HOLD_TRIES`` runs; a loop that
    takes the host more than ``HOLD_MAX_S / 2`` to queue is read as it ran
    (the device is then busy with it anyway).  Every call's outputs are
    consumed whole: a position-weighted sum of ``abs`` rows of every
    element of every output, added into one device scalar, which is read
    once at the end and must be finite.  The inputs are consumed the same way in every call, and
    the floor is the same loop with ``fn`` left out, so the floor holds
    the harness's own cost and a floor-subtracted time keeps about one
    read of ``fn``'s outputs.  Eager PyTorch eliminates no work, so unlike
    the JAX harness's ``lax.scan`` no input roll is needed to keep the
    calls from being hoisted or merged.  On the CPU (tensors on the CPU:
    the caller's choice) the loop is timed by ``time.perf_counter``.
    """
    n = k * iters
    dev = _leaves(args)[0].device

    def body(acc, run_fn):
        tot = _consume(args)
        if run_fn:
            tot = tot + _consume(fn(*args))
        return acc + tot * 1e-30

    def timed(run_fn):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        acc = body(acc, run_fn)  # warm-up
        if dev.type == "cuda":
            hold = HOLD_S
            for _ in range(HOLD_TRIES):
                torch.cuda.synchronize(dev)
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                torch.cuda._sleep(int(hold * HOLD_CLOCK_HZ))
                t0.record()
                h0 = time.perf_counter()
                for _ in range(n):
                    acc = body(acc, run_fn)
                t1.record()
                queued = time.perf_counter() - h0
                if not t0.query() or 2 * queued > HOLD_MAX_S:
                    break   # queued ahead of the device, or too long to hold
                hold = 2 * queued
            total = float(acc)
            dt = t0.elapsed_time(t1) / 1e3 / n
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                acc = body(acc, run_fn)
            total = float(acc)
            dt = (time.perf_counter() - t0) / n
        if not math.isfinite(total):
            raise RuntimeError(f"the harness's consumed sum is {total}")
        return dt

    dt = timed(True)
    if not with_floor:
        return dt
    return dt, timed(False)


def level_cost(segments, layers, kw, batch: int) -> dict:
    """One recorded dense block's name (as the JAX CLI names it), FLOPs
    (the JAX formula) and the bytes the port's kernels move; ``dense``
    the bytes of its dense layers alone."""
    _, _, h, w = segments[0].shape
    item = segments[0].element_size()
    pix = h * w
    c_in = sum(s.shape[1] for s in segments)
    n = len(layers)
    g = layers[0].weight.shape[2]
    c_t = c_in + n * g
    td, cls = kw.get("td"), kw.get("cls")
    flops = sum(2 * 9 * g * (c_in + j * g) * pix for j in range(n)) * batch
    dense = sum(batch * pix * (lay.weight.shape[0] + g) * item
                + lay.weight.numel() * item + 8 * lay.weight.shape[0] + 4 * g
                for lay in layers)
    moved = dense + 2 * batch * pix * c_in * item  # the virtual concat
    if td is not None:
        flops += 2 * c_t * c_t * pix * batch
        c, n_out = td.weight.shape
        moved += (batch * pix * (c + n_out) * item + td.weight.numel() * item
                  + 8 * c + 4 * n_out)
    if cls is not None:
        flops += 2 * 8 * c_t * pix * batch
        moved += (batch * pix * (c_t * item + 8 * 4)
                  + cls.weight.numel() * item + 32)
    name = (f"{h}x{w} c_in={c_in} n={n}" + (" +TD" if td is not None else "")
            + (" +cls" if cls is not None else ""))
    return {"name": name, "h": h, "w": w, "c_in": c_in, "n": n, "growth": g,
            "td": td is not None, "cls": cls is not None, "flops": flops,
            "bytes": moved, "dense_bytes": dense}


def rates(flops: float, moved: float, dt: float, args,
          on_card: bool) -> dict:
    """The achieved rates and the shares of the card's peaks; None off a
    card, where a host time says nothing of the device."""
    if not on_card:
        return dict.fromkeys(("tflops", "mxu_pct", "hbm_gb_s", "hbm_pct"))
    return {"tflops": flops / dt / 1e12,
            "mxu_pct": 100 * flops / dt / 1e12 / args.peak_tflops,
            "hbm_gb_s": moved / dt / 1e9,
            "hbm_pct": 100 * moved / dt / 1e9 / args.peak_gbps}


def _f(v, width: int) -> str:
    return f"{'-':>{width}s}" if v is None else f"{v:{width}.1f}"


def ablated_block(segments, layers, mode: str, *, c_lo: int, td=None,
                  cls=None):
    """``kernels.dense_block.dense_block`` with every dense layer run as
    the diagnostic variant ``mode`` (``dense_layer(..., ablate=mode)``)."""
    from ..kernels import dense_block as kdb

    return kdb._run_block(list(segments), layers, c_lo, td, cls,
                          functools.partial(kdb.dense_layer, ablate=mode),
                          kdb.transition, kdb.classifier)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="67", choices=["67", "57", "103"])
    p.add_argument("-b", "--batch_size", type=int, default=256)
    p.add_argument("--peak_tflops", type=float, default=H100_PEAK_TFLOPS,
                   help="the card's dense bf16 peak (H100 SXM: 989 TFLOP/s)")
    p.add_argument("--peak_gbps", type=float, default=H100_PEAK_GBPS,
                   help="the card's HBM rate (H100 SXM: 3350 GB/s)")
    p.add_argument("--ablate", default=None, metavar="SUBSTR",
                   help="for each level whose name contains SUBSTR, also "
                        "time it with its dense layers as the two "
                        "diagnostic variants of the tensor-core layer: the "
                        "centre tap alone ('no_taps') and x without BN + "
                        "ReLU ('no_prep'); wrong math, right timing")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def build(arch: str, device, n_cls: int = 4):
    """A seeded FCDenseNet of ``arch`` in eval mode on ``device``."""
    from ..core.dtypes import DEFAULT_POLICY
    from ..models.tiramisu import fcdensenet57, fcdensenet67, fcdensenet103

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = {"57": lambda: fcdensenet57(n_cls, policy=DEFAULT_POLICY),
                 "67": lambda: fcdensenet67(n_cls, DEFAULT_POLICY),
                 "103": lambda: fcdensenet103(n_cls, DEFAULT_POLICY)}[arch]()
    return model.to(device).eval()


@torch.no_grad()
def main(args=None, device=None) -> dict:
    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    device = runtime.resolve_device(device if device is not None
                                    else args.device)
    card = runtime.device_label(device)

    from ..kernels import dense_block as kdb
    from ..models.tiramisu_fused import fold_model, fused_apply
    from ..ops.augment import AugmentConfig
    from ..train.supervised import model_batch

    b = args.batch_size
    on_card = device.type == "cuda"
    model = build(args.arch, device)
    folded = fold_model(model)
    imgs = np.random.default_rng(0).integers(
        0, 255, (b, HEIGHT, WIDTH, 3), dtype=np.uint8)
    cfg = AugmentConfig(height=HEIGHT, width=WIDTH)
    x, _ = model_batch(torch.from_numpy(imgs).to(device), None, cfg)

    # -- record every dense block of one real forward ----------------------
    calls = []

    def recorder(segments, layers, **kw):
        calls.append((list(segments), layers, dict(kw)))
        return kdb.dense_block(segments, layers, **kw)

    kdb.reset_launches()
    fused_apply(model, x, folded, use_softmax=False, block_fn=recorder)
    per_forward = dict(kdb.launches)
    timing = dict(k=K, iters=ITERS, with_floor=True)

    # -- time each level beside its bounds ---------------------------------
    rows, t_sum, dense_bytes = [], 0.0, 0
    for segments, layers, kw in calls:
        cost = level_cost(segments, layers, kw, b)
        dense_bytes += cost["dense_bytes"]
        dt, dt_floor = _time_scan(
            lambda *s: kdb.dense_block(list(s), layers, **kw),
            tuple(segments), **timing)
        dt = max(dt - dt_floor, 1e-9)
        t_sum += dt
        name = cost["name"]
        abl = {}
        if args.ablate is not None and args.ablate in name:
            for mode in kdb.ABLATIONS:
                try:
                    dt_a, dt_af = _time_scan(
                        lambda *s: ablated_block(s, layers, mode, **kw),
                        tuple(segments), **timing)
                except ValueError as e:  # off the tensor-core route
                    print(f"ablate skipped for {name}: {e}")
                    break
                abl[mode + "_ms"] = max(dt_a - dt_af, 0.0) * 1e3
        flops, moved = cost["flops"], cost["bytes"]
        bound = max(flops / (args.peak_tflops * 1e12),
                    moved / (args.peak_gbps * 1e9))
        rows.append({
            "level": name, **{k: cost[k] for k in (
                "h", "w", "c_in", "n", "growth", "td", "cls")},
            "floor_ms": dt_floor * 1e3, **abl, "ms": dt * 1e3,
            "gflop": flops / 1e9, "gb": moved / 1e9,
            "bound_ms": bound * 1e3,
            **rates(flops, moved, dt, args, on_card),
        })
    del calls

    # the full forward in FULL_RUNS runs: their median, and their spread
    runs = [_time_scan(lambda xx: fused_apply(model, xx, folded,
                                              use_softmax=False),
                       (x,), **timing) for _ in range(FULL_RUNS)]
    nets = sorted(max(dt - fl, 1e-9) for dt, fl in runs)
    dt_full = nets[len(nets) // 2]
    spread = nets[-1] - nets[0]
    dt_full_floor = sorted(fl for _, fl in runs)[len(runs) // 2]
    fps = b / dt_full
    total_gf = sum(r["gflop"] for r in rows)
    glue_ms = (dt_full - t_sum) * 1e3

    print(f"\nNOTE: every row is floor-subtracted: the same loop with the "
          f"block left out (its inputs still consumed) is timed per level "
          f"and its per-call cost (floor_ms) removed; what is left of the "
          f"harness in a row is about one read of the level's outputs.  "
          f"Bytes are the port's kernels' traffic.  [{card}]")
    print(f"\n{'level':36s} {'ms':>8s} {'bound':>8s} {'GFLOP':>8s} "
          f"{'TF/s':>6s} {'MXU%':>5s} {'HBM GB/s':>9s} {'HBM%':>5s}  [{card}]")
    for r in rows:
        print(f"{r['level']:36s} {r['ms']:8.3f} {r['bound_ms']:8.3f} "
              f"{r['gflop']:8.1f} {_f(r['tflops'], 6)} {_f(r['mxu_pct'], 5)} "
              f"{_f(r['hbm_gb_s'], 9)} {_f(r['hbm_pct'], 5)}  [{card}]")
        if "no_taps_ms" in r and "no_prep_ms" in r:
            taps = r["ms"] - r["no_taps_ms"]
            prep = r["ms"] - r["no_prep_ms"]
            print(f"{'  ablations: 9-tap reduction':36s} {taps:8.3f}   "
                  f"({100 * taps / r['ms']:.0f}% of level)  [{card}]")
            print(f"{'  ablations: BN/ReLU feed':36s} {prep:8.3f}   "
                  f"({100 * prep / r['ms']:.0f}% of level)  [{card}]")
    print(f"{'sum of fused levels':36s} {t_sum * 1e3:8.3f}  [{card}]")
    print(f"{'full forward (incl. glue)':36s} {dt_full * 1e3:8.3f}   "
          f"glue {glue_ms:.3f} ms ({100 * glue_ms / (dt_full * 1e3):.0f}%); "
          f"spread of {FULL_RUNS} runs {spread * 1e3:.3f} ms  [{card}]")
    print(f"throughput: {fps:,.0f} frames/s at batch {b}  [{card}]")
    print(f"compute-bound ceiling at {args.peak_tflops:g} TFLOP/s: "
          f"{args.peak_tflops * 1e3 / (total_gf / b):,.0f} frames/s "
          f"({total_gf / b:.2f} GFLOP/frame)  [{card}]")
    result = {"card": card, "device": str(device), "batch": b,
              "fps": fps, "full_ms": dt_full * 1e3,
              "full_floor_ms": dt_full_floor * 1e3,
              "full_spread_ms": spread * 1e3, "levels": rows,
              "sum_ms": t_sum * 1e3, "glue_ms": glue_ms,
              "gflop_per_frame": total_gf / b,
              "dense_layer_bound_ms": dense_bytes / (args.peak_gbps * 1e9)
              * 1e3,
              "launches_per_forward": per_forward}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
