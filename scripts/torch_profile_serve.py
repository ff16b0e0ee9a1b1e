#!/usr/bin/env python3
"""Where the port's serving forwards spend their device time.

    python3 scripts/torch_profile_serve.py [--batch 64]

Needs one CUDA card.  Builds the serving kernels and, under
``torch.profiler``, runs at B=64 on 120x160 frames:

1. the fused FCDenseNet67 forward (``fused_apply``, weights from a seed as
   ``chip_smoke.py`` makes them);
2. the classifier tail alone (``kernels/dense_block.classifier``) on the
   last block's features of that forward;
3. K6, the int8 body of the committed LaneNetLite student
   (``kernels/int8_body.int8_body`` on the stem rows of the frames,
   calibrated as ``cli.serve --int8`` does);
4. K5, label extraction (``kernels/labelgen.process_classes``) on
   ``--label_batch`` seeded 480x640 pairs, as ``chip_smoke.py`` makes them.

For each it prints the time per call by CUDA events, the device time per
CUDA kernel name (per call, largest first) and the card's busy and idle
share; for K6 also each conv site's time by CUDA events around its
launch (its shape, route and TOP/s).  Every line carries the card's name
and power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profile_calls(fn, label, card, reps, top):
    """Events time of one call of ``fn``, then its device time by kernel
    name over ``reps`` calls under the profiler, printed per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    ms = cs._time_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side entries only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.count, getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0)))
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU]
    rows = sorted(((k, n / reps, t / 1e3 / reps) for k, n, t in rows if t > 0),
                  key=lambda r: -r[2])
    busy = sum(t for _, _, t in rows)
    print(f"{label}: {ms:.3f} ms a call by events; device busy {busy:.3f} ms "
          f"(idle share {max(0.0, 1 - busy / ms):.3f})  [{card}]")
    for k, n, t in rows[:top]:
        print(f"  {t:9.3f} ms  {n:6.1f} launches  {k[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--label_batch", type=int, default=32)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib
    from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg
    from sim2real_lane_segment_tpu_torch.models.lanenet_fused import \
        fold_body
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import (
        fold_model, fused_apply)

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = cs.card_label()
    device = torch.device("cuda")
    frames = cs.synthetic_frames(np.random.default_rng(cs.SEED + 3),
                                 args.batch)

    model = cs.make_model(cs.seeded_state_dict(device), DEFAULT_POLICY,
                          device)
    folded = fold_model(model)
    x = cs.model_input(frames, device)
    with torch.no_grad():
        profile_calls(lambda: fused_apply(model, x, folded, use_softmax=False),
                      f"FCDenseNet67 fused forward B={args.batch}", card,
                      args.reps, args.top)
        _, segs, layers, kw = cs.capture_blocks(model, x, folded)[-1]
        feat = kdb.dense_block_plain(segs, layers, c_lo=0)
        profile_calls(lambda: kdb.classifier(feat, kw["cls"]),
                      f"classifier alone B={args.batch} "
                      f"{list(feat.shape)}", card, args.reps, args.top)
        del feat, segs

    _, qn = cs.lite_quantized(device)
    body = fold_body(qn)
    rows, hh, ww = cs.stem_rows(qn, frames, device)
    with torch.no_grad():
        profile_calls(lambda: kib.int8_body(rows, body, hh, ww),
                      f"K6 int8 body B={args.batch} ({hh}x{ww} rows)", card,
                      args.reps, args.top)
        site_times(rows, body, hh, ww, card, args.reps)

    orig, annot = (torch.from_numpy(a).to(device) for a in cs.label_pairs(
        np.random.default_rng(cs.SEED + 13), args.label_batch, 480, 640))
    profile_calls(lambda: klg.process_classes(orig, annot),
                  f"K5 labels B={args.label_batch} 480x640", card, args.reps,
                  args.top)


def site_times(rows, body, hh, ww, card, reps):
    """CUDA events around each K6 conv launch of one body call, averaged
    over ``reps`` calls."""
    from unittest import mock

    import torch

    from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib

    real = kib._conv
    spans = []

    def timed(q, spec, h, w, **kw):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        mma = kib.mma_launches["conv"]
        t0.record()
        out = real(q, spec, h, w, **kw)
        t1.record()
        # the route as the C library reported it
        route = "imma" if kib.mma_launches["conv"] > mma else "dp4a"
        spans.append((spec, q.shape, route, t0, t1))
        return out

    kib.int8_body(rows, body, hh, ww)
    with mock.patch.object(kib, "_conv", timed):
        for _ in range(reps):
            kib.int8_body(rows, body, hh, ww)
    torch.cuda.synchronize()
    n = len(spans) // reps
    print(f"K6 conv sites by CUDA events (wrapper included), mean of {reps} "
          f"calls  [{card}]")
    total = 0.0
    for i in range(n):
        spec, (b, p, cin), route, _, _ = spans[i]
        ms = sum(t0.elapsed_time(t1) for *_, t0, t1 in spans[i::n]) / reps
        total += ms
        cout = spec.w_rows.shape[1]
        ops = 2.0 * b * p * spec.w_rows.numel()
        print(f"  {spec.name:18s} {spec.taps} taps dil {spec.dilation} "
              f"{cin:3d}->{cout:3d} {route}: {ms:7.4f} ms, "
              f"{ops / ms / 1e9:7.1f} TOP/s")
    print(f"  all {n} conv sites {total:.4f} ms")


if __name__ == "__main__":
    main()
