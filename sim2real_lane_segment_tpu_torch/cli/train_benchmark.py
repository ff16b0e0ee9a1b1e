"""Sustained training throughput (images/s) per architecture on the card.

Counterpart of the JAX package's ``cli/train_benchmark.py``: the full
augmented train step (augmentation on the device, forward, backward,
AdamW, running statistics) on a fixed uint8 batch, one JSON line per
architecture:

    python -m sim2real_lane_segment_tpu_torch.cli.train_benchmark --archs 67 lite
    python -m sim2real_lane_segment_tpu_torch.cli.train_benchmark --pallas_train
    python -m sim2real_lane_segment_tpu_torch.cli.train_benchmark --stages

The JAX CLI runs ``--steps`` steps per ``lax.scan`` dispatch.  The port's
counterpart of that dispatch is the one ``fit`` takes with
``--device_cache``: ``SupervisedTrainer.run_scan_chunk``, on a card one
replay of the step captured as a CUDA graph (``train.graphs``) per step.
``fit`` graphs every architecture and flag of ``SupervisedTrainer`` on a
card, so every headline number here is taken through it; on the CPU
``run_scan_chunk`` runs eager steps.  Each JSON line names its dispatch.
LaneNetLite has no fused train path: under ``--pallas_train`` it trains
plain and its line is named without ``_pallas`` (the JAX CLI names the
line by the flag).

``--stages`` times the step's parts alone, under the JAX names
(``augment``, ``aug/hsv``, ``aug/crop``, ``aug/oneof``, ``forward``,
``fwd+bwd``, ``optimizer``, ``full_step``), each as eager calls (``fit``
graphs whole steps only), with its random draws as tensors
(``ops.augment.draw_augment``) made in each call; every stage folds a
scalar of its output into a device sum, so none is skipped.  The stages
do not add up to the step: they locate the largest cost.  Every line
carries the card's name and power limit.

Runs on the card unless given ``--device cpu`` (or ``main(...,
device="cpu")``), where the times are the host's.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import runtime
from . import common

HEIGHT, WIDTH = 120, 160   # the frames the JAX CLI trains on
STAGES = ("augment", "aug/hsv", "aug/crop", "aug/oneof", "forward",
          "fwd+bwd", "optimizer", "full_step")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trainer(arch: str, device, **flags):
    from ..train.supervised import SupervisedTrainer
    from .test import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(arch, 4)
    return SupervisedTrainer(num_cls=4, augment=True, model=model,
                             height=HEIGHT, width=WIDTH, device=device,
                             **flags)


def _batch(batch: int, device):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 255, (batch, HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(
        0, 4, (batch, HEIGHT, WIDTH), dtype=np.uint8)).to(device)
    return images, labels


def metric_name(arch: str, fast_train: bool, pallas_train: bool) -> str:
    return (f"train_images_per_sec_{arch}" + ("_fast" if fast_train else "")
            + ("_pallas" if pallas_train else ""))


def measure(arch: str, batch: int, steps: int, iters: int,
            fast_train: bool = False, pallas_train: bool = False,
            device=None) -> dict:
    """``iters`` dispatches of ``steps`` train steps each, after one
    untimed dispatch (which captures the step on a card)."""
    device = runtime.resolve_device(device)
    trainer = _trainer(arch, device, fast_train=fast_train,
                       pallas_train=pallas_train)
    arrays = _batch(batch, device)
    idx = np.tile(np.arange(batch), (steps, 1))
    gen = torch.Generator().manual_seed(1)

    logs = trainer.run_scan_chunk(arrays, idx, gen, 0)  # warm-up, capture
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        logs = trainer.run_scan_chunk(arrays, idx, gen, 0)
    _sync(device)
    dt = time.perf_counter() - t0
    return {"metric": metric_name(arch, fast_train, pallas_train),
            "value": batch * steps * iters / dt, "unit": "images/sec/chip",
            "batch": batch, "step_ms": dt / (steps * iters) * 1e3,
            "final_loss": float(logs["tr_loss"][-1]),
            "dispatch": "cuda_graph" if device.type == "cuda" else "eager",
            "device": str(device), "card": runtime.device_label(device)}


def measure_stages(arch: str, batch: int, steps: int, iters: int,
                   device=None) -> dict:
    """Per-stage milliseconds of the full train step (eager calls)."""
    from ..models.tiramisu import draw_drop_masks
    from ..ops import augment as aug
    from ..ops.colorspace import shift_hsv
    from ..train.losses import weighted_cross_entropy
    from ..train.supervised import model_batch

    device = runtime.resolve_device(device)
    trainer = _trainer(arch, device)
    cfg = trainer.cfg
    images, labels = _batch(batch, device)
    gen = torch.Generator().manual_seed(1)

    def draws():
        return aug.draw_augment(gen, batch, cfg, device)

    # fixed post-augment inputs for the model and optimizer stages
    d0 = draws()
    x0_nhwc, _ = aug.augment_batch(images, labels, cfg, d0)
    x0, y0 = model_batch(images, labels, cfg, d0)
    params = trainer.params

    def fwd_loss():
        flat = draw_drop_masks(gen, trainer.model, batch,
                               size=(HEIGHT, WIDTH))
        out, _ = trainer._forward(x0, trainer._masks(flat, batch))
        return weighted_cross_entropy(out, y0, trainer.num_cls)

    grads0 = [g.detach() for g in torch.autograd.grad(fwd_loss(), params)]

    def stage_augment():
        x, y = aug.augment_batch(images, labels, cfg, draws())
        return x.mean() + y.sum().to(torch.float32)

    def stage_hsv():
        hsv = draws().hsv.view(batch, 3, 1, 1)
        x = shift_hsv(images, hsv[:, 0] * cfg.hue_limit,
                      hsv[:, 1] * cfg.sat_limit, hsv[:, 2] * cfg.val_limit,
                      cfg.channel_order)
        return x.mean()

    def stage_crop():
        x, y = aug.random_sized_crop(images.to(torch.float32), labels,
                                     draws(), cfg)
        return x.mean() + y.sum().to(torch.float32)

    def stage_oneof():
        d = draws()
        n = batch
        blurred = aug.motion_blur(x0_nhwc,
                                  aug._blur_bank(device)[d.blur_idx])
        sigma = torch.sqrt(d.sigma2).view(n, 1, 1, 1)
        noisy = x0_nhwc + sigma * d.noise
        return torch.where(d.use_blur.view(n, 1, 1, 1), blurred,
                           noisy).mean()

    def stage_forward():
        with torch.no_grad():
            return fwd_loss()

    def stage_fwd_bwd():
        loss = fwd_loss()
        grads = torch.autograd.grad(loss, params)
        return loss.detach() + grads[0].mean()

    def stage_optimizer():
        trainer.opt.set_lr(trainer.lr)
        trainer.opt.step(grads0)
        return params[0].detach().mean()

    def stage_full():
        return trainer.train_step(images, labels, trainer.lr,
                                  generator=gen)["tr_loss"]

    stages = dict(zip(STAGES, (stage_augment, stage_hsv, stage_crop,
                               stage_oneof, stage_forward, stage_fwd_bwd,
                               stage_optimizer, stage_full)))
    out = {"metric": f"train_stage_ms_{arch}", "batch": batch,
           "unit": "ms/step", "dispatch": "eager", "device": str(device),
           "card": runtime.device_label(device)}
    for name, fn in stages.items():
        c = fn()  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps * iters):
            c = c + fn()
        total = float(c)  # waits for the device
        out[name] = (time.perf_counter() - t0) / (steps * iters) * 1e3
        if not np.isfinite(total):
            raise RuntimeError(f"stage {name}: its sum is {total}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--archs", nargs="+", default=["67", "lite"])
    p.add_argument("-b", "--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=20,
                   help="train steps per dispatch (run_scan_chunk length)")
    p.add_argument("--iters", type=int, default=3,
                   help="measured dispatches")
    p.add_argument("--stages", action="store_true",
                   help="per-stage breakdown (augment substages, forward, "
                        "fwd+bwd, optimizer) instead of the headline number")
    p.add_argument("--fast_train", action="store_true",
                   help="measure the segment-wise FC-DenseNet train forward "
                        "(models/tiramisu_fast.fast_apply_train)")
    p.add_argument("--pallas_train", action="store_true",
                   help="measure the fused-kernel train step "
                        "(models/tiramisu_train_fused.fused_apply_train)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(args=None, device=None) -> list:
    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    device = runtime.resolve_device(device if device is not None
                                    else args.device)
    out = []
    for arch in args.archs:
        if args.stages:
            row = measure_stages(arch, args.batch_size, args.steps,
                                 args.iters, device)
        else:
            # --pallas_train takes an FC-DenseNet; LaneNetLite trains plain
            pallas = args.pallas_train and arch != "lite"
            row = measure(arch, args.batch_size, args.steps, args.iters,
                          args.fast_train, pallas, device)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
