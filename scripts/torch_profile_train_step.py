#!/usr/bin/env python3
"""Where one ``--pallas_train`` step of the PyTorch port spends its time.

    python3 scripts/torch_profile_train_step.py [--arch 67] [--batch 32]

Needs one CUDA card.  Builds the train kernels, runs B=32 train steps of
FCDenseNet67 (``--arch`` 67, 57 or 103) at 120x160 (weights, frames and
dropout masks from a seed, as ``chip_smoke.py`` makes them) and prints
three tables:

1. device time per CUDA kernel name, summed over one step
   (``torch.profiler``), and the card's busy and idle share of the step;
2. device time per kernel wrapper (K1, K2, K3a, K3b) and resolution:
   CUDA events around every wrapper call of one step, and each call
   again alone on the step's own operands, queued behind a spin kernel
   (``chip_smoke._held_ms``: the host's launch cost left out); and the
   share of the latter at small planes, whose pixels fill under half of
   their 12x16 tensor-core tiles (``train_block.small_plane``);
3. the largest device-time entries of the step that are not the port's
   kernels (the train step's glue), by name.

Every line carries the card's name and power limit.  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WRAPPERS = ("consumer_fwd", "consumer_bwd", "stage", "final")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="67", choices=("67", "57", "103"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.train.supervised import \
        SupervisedTrainer

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = cs.card_label()
    device = torch.device("cuda")
    sd = cs.seeded_state_dict(device, args.arch)
    rng = np.random.default_rng(cs.SEED + 9)
    images = cs.synthetic_frames(rng, args.batch)
    labels = rng.integers(0, cs.N_CLS, (args.batch, cs.H, cs.W)).astype(
        np.uint8)
    model = build_model(args.arch, cs.N_CLS)
    model.load_state_dict(sd)
    trainer = SupervisedTrainer(num_cls=cs.N_CLS, model=model,
                                pallas_train=True)
    masks = cs.train_masks(trainer.model, args.batch, device, cs.SEED + 10)

    def step():
        trainer.train_step(images, labels, 1e-3, masks=masks)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    ms = cs._time_ms(step, 3)
    print(f"step: FCDenseNet{args.arch} B={args.batch} --pallas_train "
          f"{ms:.3f} ms  [{card}]")

    # 1 and 3: one step under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # device-side entries only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.count, getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0)))
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU]
    rows = [(k, n, t / 1e3) for k, n, t in rows if t > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(t for _, _, t in rows)
    print(f"profile: device busy {busy:.3f} ms of the {ms:.3f} ms step "
          f"(idle share {max(0.0, 1 - busy / ms):.3f})  [{card}]")
    ours = [r for r in rows if "(anonymous namespace)::" in r[0]
            or "s2r_" in r[0]]
    print(f"profile: the port's kernels by name, one step  [{card}]")
    for k, n, t in ours:
        print(f"  {t:9.3f} ms  {n:5d} launches  {k[:110]}")
    print(f"profile: the port's kernels {sum(t for _, _, t in ours):.3f} ms; "
          f"everything else {busy - sum(t for _, _, t in ours):.3f} ms, "
          f"largest first  [{card}]")
    names = {r[0] for r in ours}
    for k, n, t in [r for r in rows if r[0] not in names][:args.top]:
        print(f"  {t:9.3f} ms  {n:5d} launches  {k[:110]}")

    # 2: CUDA events around every wrapper call of one step
    real = {k: getattr(ktb, k) for k in WRAPPERS}
    spans, calls = [], []

    def timed(name):
        def wrapper(x, *a, **kw):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            out = real[name](x, *a, **kw)
            t1.record()
            taps = a[2].shape[1] if name in ("consumer_fwd",
                                             "consumer_bwd") else 9
            key = (name, taps, x.shape[2], x.shape[3])
            spans.append((*key, t0, t1))
            calls.append((key, (x, *a), kw))
            return out
        return wrapper

    with mock.patch.multiple(ktb, **{k: timed(k) for k in WRAPPERS}):
        step()
    torch.cuda.synchronize()
    table = defaultdict(lambda: [0, 0.0, 0.0])  # calls, events, alone
    for name, taps, h, w, t0, t1 in spans:
        cell = table[(name, taps, h, w)]
        cell[0] += 1
        cell[1] += t0.elapsed_time(t1)
    for key, a, kw in calls:
        table[key][2] += cs._held_ms(lambda: real[key[0]](*a, **kw))
    del calls
    print(f"events: device time per wrapper, taps and resolution, one step: "
          f"in the step (includes the wrapper's host time where the card "
          f"waits on it) and each call alone  [{card}]")
    for (name, taps, h, w), (n, t, alone) in sorted(table.items()):
        tag = "  small plane" if ktb.small_plane(h, w) else ""
        print(f"  {name:13s} taps {taps} {h:3d}x{w:<3d} {n:3d} calls "
              f"{t:9.3f} ms, alone {alone:8.3f} ms{tag}")
    for name in WRAPPERS:
        print(f"  {name:13s} total " + ", alone ".join(
            f"{sum(c[i] for (k, *_), c in table.items() if k == name):.3f}"
            for i in (1, 2)) + " ms")
    n, total = (sum(c[i] for c in table.values()) for i in (0, 2))
    small = [c for (_, _, h, w), c in table.items() if ktb.small_plane(h, w)]
    small_n, small_ms = (sum(c[i] for c in small) for i in (0, 2))
    print(f"events: the four wrappers' calls alone {total:.3f} ms, "
          f"{small_ms:.3f} ms ({100 * small_ms / total:.1f}%) at small "
          f"planes, in {small_n} of {n} calls  [{card}]")


if __name__ == "__main__":
    main()
