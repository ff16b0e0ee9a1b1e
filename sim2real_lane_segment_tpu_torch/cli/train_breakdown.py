"""Per-consumer breakdown of the fused FCDenseNet train path
(``models/tiramisu_train_fused``, kernels K1, K2, K3a, K3b) on the card.

Counterpart of the JAX package's ``cli/train_breakdown.py``:

    python -m sim2real_lane_segment_tpu_torch.cli.train_breakdown --arch 67 -b 128

Method (the harness of ``cli/serve_breakdown``): one real
``fused_apply_train`` forward records every ``Consumer.apply`` call
through its ``consumer_fn`` hook: the five TransitionDown sites (one
tap), since the dense layers run inside ``FusedBlock``.  Each
recorded call is re-timed alone, its forward (K1) and a standalone
vector-Jacobian product of ``sum(out**2)`` with respect to every
differentiable input (K1 then K2).  Then the full forward, the full
forward and backward (K1-K3b), and the full ``SupervisedTrainer.
train_step`` with ``pallas_train`` (augmentation, forward, backward, loss,
AdamW, running statistics), whose updated parameters are consumed with
its loss, so the gap left to the glue is explicit at each level.  Every
row is floor-subtracted; every printed time carries the card's name and
power limit.

Runs on the card unless given ``--device cpu`` (or ``main(...,
device="cpu")``), where the kernels' plain versions run and the times are
the host's.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core import runtime
from . import common
from .serve_breakdown import H100_PEAK_TFLOPS, _time_scan, build

HEIGHT, WIDTH = 120, 160   # the frames the JAX CLI times
# calls a timed run of a consumer or the full forward, of the backward and
# the step, and runs (``_time_scan``), as the JAX CLI times them
K, K_FULL, ITERS = 8, 4, 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="67", choices=["67", "57", "103"])
    p.add_argument("-b", "--batch_size", type=int, default=128)
    p.add_argument("--peak_tflops", type=float, default=H100_PEAK_TFLOPS,
                   help="the card's dense bf16 peak (H100 SXM: 989 TFLOP/s)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(args=None, device=None) -> dict:
    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    device = runtime.resolve_device(device if device is not None
                                    else args.device)
    card = runtime.device_label(device)
    on_card = device.type == "cuda"

    from ..models import tiramisu_train_fused as ttf
    from ..models.tiramisu import drop_masks
    from ..train.supervised import SupervisedTrainer
    from .test import build_model

    b, h, w = args.batch_size, HEIGHT, WIDTH
    model = build(args.arch, device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, 3, h, w))
                         .astype(np.float32)).to(device)
    masks = drop_masks(torch.Generator().manual_seed(1), model, b, device)

    # -- record every fused consumer call from one real forward ------------
    calls = []
    real = ttf.Consumer.apply

    def recorder(*a):
        calls.append(tuple(t.detach() for t in a))
        return real(*a)

    with torch.no_grad():
        ttf.fused_apply_train(model, x, masks, use_softmax=False,
                              consumer_fn=recorder)

    timing = dict(k=K, iters=ITERS, with_floor=True)
    full = dict(k=K_FULL, iters=ITERS, with_floor=True)

    def fwd(*a):
        with torch.no_grad():
            return real(*a)

    def vjp(*a):
        with torch.enable_grad():
            leaves = [t.requires_grad_() for t in (t.detach() for t in a[:5])]
            out = real(*leaves, a[5])
            s = (out.to(torch.float32) ** 2).sum()
            return (s.detach(), *torch.autograd.grad(s, leaves))

    rows, t_fwd_sum, t_vjp_sum = [], 0.0, 0.0
    for arg in calls:
        dt_f, fl_f = _time_scan(fwd, arg, **timing)
        dt_f = max(dt_f - fl_f, 1e-9)
        dt_b, fl_b = _time_scan(vjp, arg, **timing)
        dt_b = max(dt_b - fl_b, 1e-9)
        t_fwd_sum += dt_f
        t_vjp_sum += dt_b
        xin, weight = arg[0], arg[3]
        c_in, taps, g_out = weight.shape
        pix = xin.shape[2] * xin.shape[3]
        flops = 2 * taps * g_out * c_in * pix * b
        rows.append({
            "level": f"{xin.shape[2]}x{xin.shape[3]} c_in={c_in} "
                     f"taps={taps} g={g_out}",
            "h": xin.shape[2], "w": xin.shape[3], "c_in": c_in, "taps": taps,
            "g_out": g_out, "fwd_ms": dt_f * 1e3, "vjp_ms": dt_b * 1e3,
            "gflop": flops / 1e9,
            "fwd_mxu_pct": (100 * flops / dt_f / 1e12 / args.peak_tflops
                            if on_card else None),
        })
    del calls

    def full_fwd(xx):
        with torch.no_grad():
            return ttf.fused_apply_train(model, xx, masks,
                                         use_softmax=False)[0]

    dt_full, fl = _time_scan(full_fwd, (x,), **timing)
    dt_full = max(dt_full - fl, 1e-9)

    params = list(model.parameters())

    def full_bwd(xx):
        out, _ = ttf.fused_apply_train(model, xx, masks, use_softmax=False)
        loss = (out.to(torch.float32) ** 2).mean()
        return (loss.detach(), *torch.autograd.grad(loss, params))

    dt_fb, fl = _time_scan(full_bwd, (x,), **full)
    dt_fb = max(dt_fb - fl, 1e-9)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = build_model(args.arch, 4)
    trainer = SupervisedTrainer(num_cls=4, augment=True, model=net,
                                pallas_train=True, height=h, width=w,
                                device=device)
    imgs = torch.from_numpy(rng.integers(0, 255, (b, h, w, 3),
                                         dtype=np.uint8)).to(device)
    lbls = torch.from_numpy(rng.integers(0, 4, (b, h, w),
                                         dtype=np.uint8)).to(device)
    gen = torch.Generator().manual_seed(2)

    def full_step(im, lb):
        logs = trainer.train_step(im, lb, 1e-3, generator=gen)
        # the updated parameters too: the harness consumes every output,
        # so the backward and the optimizer are read as well as the loss
        return logs["tr_loss"], trainer.params

    dt_step, fl = _time_scan(full_step, (imgs, lbls), **full)
    dt_step = max(dt_step - fl, 1e-9)

    print(f"\nNOTE: every row is floor-subtracted: the same loop with the "
          f"call left out (its inputs still consumed) is timed per row and "
          f"its per-call cost removed; what is left of the harness in a row "
          f"is about one read of its outputs (for vjp rows, of the "
          f"gradients).  [{card}]")
    print(f"\n{'consumer':34s} {'fwd ms':>8s} {'vjp ms':>8s} "
          f"{'GFLOP':>7s} {'fwdMXU%':>7s}  [{card}]")
    for r in rows:
        share = ("-" if r["fwd_mxu_pct"] is None
                 else f"{r['fwd_mxu_pct']:.1f}")
        print(f"{r['level']:34s} {r['fwd_ms']:8.3f} {r['vjp_ms']:8.3f} "
              f"{r['gflop']:7.1f} {share:>7s}  [{card}]")
    print(f"{'sum of consumers':34s} {t_fwd_sum * 1e3:8.3f} "
          f"{t_vjp_sum * 1e3:8.3f}  [{card}]")
    print(f"full fwd {dt_full * 1e3:.3f} ms  (glue "
          f"{(dt_full - t_fwd_sum) * 1e3:.3f} ms)  [{card}]")
    print(f"full fwd+bwd {dt_fb * 1e3:.3f} ms  [{card}]")
    print(f"full train_step {dt_step * 1e3:.3f} ms "
          f"({b / dt_step:,.0f} img/s)  [{card}]")
    result = {"card": card, "device": str(device), "batch": b,
              "levels": rows, "fwd_sum_ms": t_fwd_sum * 1e3,
              "vjp_sum_ms": t_vjp_sum * 1e3, "full_fwd_ms": dt_full * 1e3,
              "full_fwd_bwd_ms": dt_fb * 1e3, "step_ms": dt_step * 1e3,
              "img_s": b / dt_step}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
