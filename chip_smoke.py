#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Drives the port's serving path (``cli.serve.build_predict_fn --arch 67
--fused`` behind ``serving.BatchingEngine``) at the full width of
FCDenseNet67 (3,461,220 parameters, 120x160 frames) on random weights made
from a seed, and holds every kernel of that path against its plain PyTorch
version.  Phases:

1. device: requires CUDA, prints the card's name and power limit;
2. build: builds the kernels from ``csrc/`` with nvcc;
3. kernel against plain: all 11 dense blocks at their real widths (B=8,
   120x160), in float32 (TF32 off) and in bfloat16;
4. serve: 4 client threads x 8 requests of 1-16 frames through the engine
   (max_batch=64); checks every reply, the kernels' launch counts, and
   pixel agreement with the plain module on the card;
5. timing: CUDA events around a B=64 fused forward and around each
   kernel's launches, beside the plain versions, the cuDNN yardsticks and
   the least time the card could take (bound).

It prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
N_CLS = 4
H, W = 120, 160
CHECK_BATCH = 8
TIME_BATCH = 64
REPS = 10
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3.
# The kernels' operands are bf16 on the main path.  A card with a lower
# power limit runs below them.
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
REPLACES = "sim2real_lane_segment_tpu/models/tiramisu_pallas.py:701"
SOURCE = "sim2real_lane_segment_tpu_torch/csrc/dense_block.cu"
# float32: the kernel and the plain version sum the same float32 products
# in another order.  bfloat16: one rounding of a different f32 sum may land
# on the neighbouring bf16 value (relative step 2^-7), and later layers of
# a block see it, so the chained block gets 4 steps.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2 ** -5, atol=2 ** -5)}
ISOLATED_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
                "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
LOGIT_ATOL = {"float32": 1e-3, "bfloat16": 0.25}
MIN_ARGMAX_AGREEMENT = 0.99   # fused bf16 logits: kernel vs plain
MIN_PIXEL_AGREEMENT = 0.98    # served masks: fused kernels vs plain module


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs and weights, from SEED
# ---------------------------------------------------------------------------

def synthetic_frames(rng: np.random.Generator, n: int) -> np.ndarray:
    """uint8 (n, H, W, 3) frames with structure at several scales."""
    import torch
    import torch.nn.functional as F

    base = torch.from_numpy(rng.uniform(0, 255, (n, 3, 6, 8)).astype(
        np.float32))
    x = F.interpolate(base, size=(H, W), mode="bilinear", align_corners=False)
    x = x + torch.from_numpy(rng.normal(0, 16, (n, 3, H, W)).astype(
        np.float32))
    return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy().copy()


def seeded_state_dict(device) -> dict:
    """FCDenseNet67 weights from SEED: He-normal convs, random BatchNorm
    affine, and running statistics calibrated on synthetic frames (each
    BatchNorm gets the mean and variance of its input in one forward), so
    activations keep their scale through all 11 blocks."""
    import torch
    from torch import nn

    from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
    from sim2real_lane_segment_tpu_torch.models.tiramisu import (
        DenseLayer, TransitionDown, fcdensenet67)
    from sim2real_lane_segment_tpu_torch.ops.augment import (AugmentConfig,
                                                             eval_batch)

    gen = torch.Generator().manual_seed(SEED)
    model = fcdensenet67(N_CLS, F32_POLICY)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                k = m.weight.shape[2] * m.weight.shape[3]
                fan_in = (m.weight.shape[1] * k if isinstance(m, nn.Conv2d)
                          else m.weight.shape[0] * k / 4)  # stride-2 scatter
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.05)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.2)
    model = model.to(device).eval()

    def calibrate(module, args):
        x = args[0].float()
        bn = module.BatchNorm_0
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, (DenseLayer, TransitionDown))]
    frames = synthetic_frames(np.random.default_rng(SEED), 16)
    x, _ = eval_batch(torch.from_numpy(frames).to(device), None,
                      AugmentConfig(height=H, width=W), with_labels=False)
    with torch.no_grad():
        model(x.permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    return {k: v.cpu() for k, v in model.state_dict().items()}


def make_model(sd, policy, device):
    from sim2real_lane_segment_tpu_torch.models.tiramisu import fcdensenet67

    model = fcdensenet67(N_CLS, policy)
    model.load_state_dict(sd)
    return model.to(device).eval()


def model_input(frames: np.ndarray, device):
    import torch

    from sim2real_lane_segment_tpu_torch.ops.augment import (AugmentConfig,
                                                             eval_batch)
    x, _ = eval_batch(torch.from_numpy(frames).to(device), None,
                      AugmentConfig(height=H, width=W), with_labels=False)
    return x.permute(0, 3, 1, 2).contiguous()


def capture_blocks(model, x, folded):
    """Run the fused forward through the plain blocks and record each
    block's inputs: [(name, segments, layers, kwargs)] in forward order."""
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import \
        fused_apply

    order = ([f"denseDown{i}" for i in range(5)] + ["bottleneck"]
             + [f"denseUp{i}" for i in range(5)])
    calls = []

    def record(segments, layers, **kw):
        calls.append((order[len(calls)], [s.clone() for s in segments],
                      layers, kw))
        return kdb.dense_block_plain(segments, layers, **kw)

    fused_apply(model, x, folded, use_softmax=False, block_fn=record)
    return calls


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def compare_blocks(sd, device, dtype_name, card):
    """Phase 3 for one dtype: every block, kernel chain against plain
    chain, and each entry point on identical inputs.  Returns the largest
    isolated error per entry point."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                             F32_POLICY)
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import \
        fold_model

    policy = F32_POLICY if dtype_name == "float32" else DEFAULT_POLICY
    model = make_model(sd, policy, device)
    folded = fold_model(model)
    frames = synthetic_frames(np.random.default_rng(SEED + 1), CHECK_BATCH)
    calls = capture_blocks(model, model_input(frames, device), folded)
    check(len(calls) == 11, f"expected 11 dense blocks, saw {len(calls)}")
    errs = {"dense_layer": 0.0, "transition": 0.0, "classifier": 0.0}
    for name, segs, layers, kw in calls:
        out = kdb.dense_block(segs, layers, **kw)
        ref = kdb.dense_block_plain(segs, layers, **kw)
        torch.cuda.synchronize()
        if kw.get("td") is not None:
            pairs = [("features", out[0], ref[0]), ("td", out[1], ref[1])]
        else:
            pairs = [("logits" if kw.get("cls") is not None else "features",
                      out, ref)]
        for what, a, b in pairs:
            a, b = a.float(), b.float()
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if what == "logits":
                am, bm = a[:, :N_CLS].argmax(1), b[:, :N_CLS].argmax(1)
                agree = (am == bm).float().mean().item()
                print(f"  {dtype_name} {name:10s} logits   max|err| {err:.3e} "
                      f"(max|ref| {scale:.3e}), argmax agreement "
                      f"{agree:.6f}  [{card}]")
                check(agree >= MIN_ARGMAX_AGREEMENT,
                      f"{dtype_name} {name} argmax agreement {agree}")
                if dtype_name == "float32":
                    check(err <= LOGIT_ATOL[dtype_name],
                          f"float32 {name} logits differ by {err}")
            else:
                print(f"  {dtype_name} {name:10s} {what:8s} max|err| "
                      f"{err:.3e} (max|ref| {scale:.3e})  [{card}]")
                torch.testing.assert_close(a, b, **TOL[dtype_name],
                                           msg=f"{dtype_name} {name} {what}")
        # each entry point on the plain chain's own buffer: same inputs
        feat = kdb.dense_block_plain(segs, layers, c_lo=0)
        for lay in layers:
            k, _, g = lay.weight.shape
            buf = feat.clone()
            kdb.dense_layer(buf, lay)
            a, b = buf[:, k:k + g].float(), feat[:, k:k + g].float()
            torch.testing.assert_close(a, b, **ISOLATED_TOL[dtype_name],
                                       msg=f"{name} layer at c={k}")
            errs["dense_layer"] = max(errs["dense_layer"],
                                      (a - b).abs().max().item())
        if kw.get("td") is not None:
            a = kdb.transition(feat, kw["td"]).float()
            b = kdb.transition_plain(feat, kw["td"]).float()
            torch.testing.assert_close(a, b, **ISOLATED_TOL[dtype_name],
                                       msg=f"{name} transition")
            errs["transition"] = max(errs["transition"],
                                     (a - b).abs().max().item())
        if kw.get("cls") is not None:
            a = kdb.classifier(feat, kw["cls"])
            b = kdb.classifier_plain(feat, kw["cls"])
            err = (a - b).abs().max().item()
            check(err <= LOGIT_ATOL[dtype_name],
                  f"{name} classifier on identical features: {err}")
            errs["classifier"] = max(errs["classifier"], err)
    torch.cuda.synchronize()
    print(f"  {dtype_name} isolated entry points max|err|: "
          f"{json.dumps(errs)}  [{card}]")
    return errs


def serve_phase(sd, device, card):
    """Phase 4: the CLI predictor behind the engine, driven by 4 client
    threads.  Returns (launches, frames/s, batches)."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import serve
    from sim2real_lane_segment_tpu_torch.cli.test import \
        load_trainer_and_state
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.serving import BatchingEngine

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fcdensenet67_seeded.pt")
        torch.save(sd, path)
        args = serve.parse_args(["--checkpointPath", path, "--arch", "67",
                                 "--num_cls", str(N_CLS), "--height", str(H),
                                 "--width", str(W), "--fused"])
        predict_fn, h, w = serve.build_predict_fn(args)
        plain = load_trainer_and_state("baseline", path, num_cls=N_CLS,
                                       arch="67", height=H, width=W)
    check((h, w) == (H, W), f"predictor size {(h, w)}")

    rng = np.random.default_rng(SEED + 2)
    requests = [[synthetic_frames(rng, int(rng.integers(1, 17)))
                 for _ in range(8)] for _ in range(4)]
    replies = [[None] * 8 for _ in range(4)]
    errors = []

    def client(i):
        try:
            for j, frames in enumerate(requests[i]):
                replies[i][j] = engine.predict(frames, timeout=300)
        except Exception as e:  # reported below; the phase then fails
            errors.append(repr(e))

    kdb.reset_launches()
    engine = BatchingEngine(predict_fn, height=H, width=W, max_batch=64,
                            max_wait_ms=4.0)
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        engine.close()
    launches = dict(kdb.launches)
    check(not errors, f"engine requests failed: {errors}")
    check(not any(t.is_alive() for t in threads), "client threads hung")
    stats = engine.stats
    n_frames = sum(f.shape[0] for reqs in requests for f in reqs)
    check(stats["frames"] == n_frames,
          f"engine served {stats['frames']} of {n_frames} frames")
    batches = stats["batches"]
    expect = {"dense_layer": 55 * batches, "transition": 5 * batches,
              "classifier": batches}
    print(f"serve: {n_frames} frames in 32 requests, {batches} batches "
          f"(mean {n_frames / batches:.2f} frames), wall {wall:.3f} s, "
          f"{n_frames / wall:.1f} frames/s  [{card}]")
    print(f"serve: kernel launches {json.dumps(launches)}, expected "
          f"{json.dumps(expect)} (55/5/1 per batch)")
    check(launches == expect, "launch counts differ from 55/5/1 per batch")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the path was never launched")

    same = total = 0
    for reqs, outs in zip(requests, replies):
        for frames, out in zip(reqs, outs):
            check(isinstance(out, np.ndarray) and out.dtype == np.uint8
                  and out.shape == frames.shape[:3],
                  f"bad reply {type(out)} {getattr(out, 'shape', None)}")
            ref = plain.predict_step(frames).cpu().numpy()
            same += int((ref == out).sum())
            total += out.size
    agreement = same / total
    print(f"serve: pixel agreement fused kernels vs plain module (bf16) "
          f"{agreement:.6f} over {total} pixels")
    check(agreement >= MIN_PIXEL_AGREEMENT,
          f"pixel agreement {agreement} < {MIN_PIXEL_AGREEMENT}")
    return launches, n_frames / wall


def _time_ms(fn, reps=REPS):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timing_phase(sd, device, card, launches, errs):
    """Phase 5: B=64.  Returns the kernels line entries."""
    import torch
    import torch.nn.functional as F

    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import (
        fold_model, fused_apply)

    model = make_model(sd, DEFAULT_POLICY, device)
    folded = fold_model(model)
    x = model_input(synthetic_frames(np.random.default_rng(SEED + 3),
                                     TIME_BATCH), device)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: fused_apply(model, x, folded,
                                              use_softmax=False))
        lib_ms = _time_ms(lambda: model(x, use_softmax=False))
    print(f"timing: fused forward B={TIME_BATCH} {fwd_ms:.3f} ms "
          f"({TIME_BATCH / fwd_ms * 1e3:.1f} frames/s); plain nn.Module "
          f"forward through cuDNN {lib_ms:.3f} ms  [{card}]")

    calls = capture_blocks(model, x, folded)
    it = 2  # bf16
    t = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
             "ops": 0.0} for k in ("dense_layer", "transition", "classifier")}
    for name, segs, layers, kw in calls:
        feat = kdb.dense_block_plain(segs, layers, c_lo=0)
        b, _, h, w = feat.shape
        hw = h * w
        acts = []
        for lay in layers:
            k, _, g = lay.weight.shape
            acts.append((kdb.bn_relu_plain(feat, lay.scale, lay.shift),
                         lay.weight.reshape(k, 3, 3, g).permute(3, 0, 1, 2)
                         .contiguous()))
            t["dense_layer"]["bytes"] += (b * hw * (k + g) * it
                                          + k * 9 * g * it + 8 * k + 4 * g)
            t["dense_layer"]["ops"] += 2.0 * b * hw * k * 9 * g
        d = t["dense_layer"]
        d["ms"] += _time_ms(lambda: [kdb.dense_layer(feat, lay)
                                     for lay in layers])
        d["plain_ms"] += _time_ms(lambda: [kdb.dense_layer_plain(feat, lay)
                                           for lay in layers])
        d["library_ms"] += _time_ms(lambda: [F.conv2d(a, wo, padding=1)
                                             for a, wo in acts])
        td, cls = kw.get("td"), kw.get("cls")
        if td is not None:
            c, n = td.weight.shape
            e = t["transition"]
            e["bytes"] += b * hw * (c + n) * it + c * n * it + 8 * c + 4 * n
            e["ops"] += 2.0 * b * hw * c * n
            a = kdb.bn_relu_plain(feat, td.scale, td.shift)
            wo = td.weight.t()[:, :, None, None].contiguous()
            e["ms"] += _time_ms(lambda: kdb.transition(feat, td))
            e["plain_ms"] += _time_ms(lambda: kdb.transition_plain(feat, td))
            e["library_ms"] += _time_ms(lambda: F.conv2d(a, wo))
        if cls is not None:
            c = cls.weight.shape[1]
            e = t["classifier"]
            e["bytes"] += b * hw * c * it + b * 8 * hw * 4 + 8 * c * it + 32
            e["ops"] += b * hw * (2.0 * c + 2.0 * 8 * c)
            e["ms"] += _time_ms(lambda: kdb.classifier(feat, cls))
            e["plain_ms"] += _time_ms(lambda: kdb.classifier_plain(feat, cls))
            e["library_ms"] = None  # no single PyTorch call computes it
    kernels = []
    for name, e in t.items():
        t_bytes = e["bytes"] / PEAK_BYTES * 1e3
        t_ops = e["ops"] / PEAK_BF16_OPS * 1e3
        entry = {
            "name": f"k4_{name}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": errs[name], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": e["library_ms"]}
        kernels.append(entry)
        lib = ("n/a" if e["library_ms"] is None
               else f"{e['library_ms']:.3f} ms")
        print(f"timing: k4_{name} per B={TIME_BATCH} forward: kernel "
              f"{e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, cuDNN conv "
              f"alone {lib}, bound {entry['bound_ms']:.3f} ms "
              f"({entry['bound_by']}; {e['ops'] / 1e9:.1f} GFLOP, "
              f"{e['bytes'] / 1e9:.3f} GB)  [{card}]")
    gflop = sum(e["ops"] for e in t.values()) / TIME_BATCH / 1e9
    print(f"timing: kernels' work {gflop:.3f} GFLOP per frame; their bound "
          f"for one B={TIME_BATCH} forward "
          f"{sum(k['bound_ms'] for k in kernels):.3f} ms  [{card}]")
    return kernels


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        from sim2real_lane_segment_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    card = card_label()
    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    print(card, flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    build.load("dense_block")
    print(f"build: dense_block in {time.perf_counter() - t0:.1f} s (nvcc "
          f"{build.build_seconds.get('dense_block', 0.0):.1f} s)  [{card}]")
    for line in build.build_log.get("dense_block", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    # phase 3: kernel against plain, every block at full width
    t0 = time.perf_counter()
    sd = seeded_state_dict(device)
    errs = {}
    for dtype_name in ("float32", "bfloat16"):
        errs[dtype_name] = compare_blocks(sd, device, dtype_name, card)
    print(f"compare: done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)

    # phase 4: serve end to end
    launches, fps = serve_phase(sd, device, card)

    # phase 5: timing
    kernels = timing_phase(sd, device, card, launches, errs["bfloat16"])
    print(f"engine: {fps:.1f} frames/s end to end  [{card}]")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
