"""Simulator performance benchmark, the reference ``benchmark.py``.

Counterpart of the JAX package's ``cli/sim_benchmark.py``, with the same
measurements (reference rightLaneDatagen/benchmark.py:11-50): the env's
load time, mean reset time, and frame time and rate over a timed window
of ``DuckietownEnv`` steps (one frame rendered per step), plus the
batched-rollout rate (pixel-aligned pairs per second of
``sim.rollout.expert_rollout`` on the device).  Prints one JSON line:

    python -m sim2real_lane_segment_tpu_torch.cli.sim_benchmark

Runs on the card unless ``main`` is given ``device="cpu"``; the times are
of the device it ran on, which the JSON line names.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import runtime
from . import common


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args=None, device=None) -> dict:
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--resets", type=int, default=10)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--batch", type=int, default=8,
                   help="agents for the batched-rollout measurement")
    args = p.parse_args(args)
    runtime.set_float32_precision()
    device = runtime.resolve_device(device)

    from ..sim import lanes, render, rollout
    from ..sim.env import DuckietownEnv
    from ..sim.maps import builtin_map

    t0 = time.perf_counter()
    env = DuckietownEnv(map_name=args.map_name, camera_width=args.width,
                        camera_height=args.height, domain_rand=True,
                        device=device)
    load_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.resets):
        env.reset()
    reset_time = (time.perf_counter() - t0) / args.resets

    env.reset()
    n_frames = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        _, _, done, _ = env.step([0.3, 0.0])
        if done:
            env.reset()
        n_frames += 1
    frame_time = (time.perf_counter() - t0) / max(n_frames, 1)

    # batched rollout throughput on the device
    m = builtin_map(args.map_name)
    scene = render.build_scene(m, device=device)
    la = lanes.build_lane_arrays(m, device)
    pos, angle = rollout.sample_spawns(m, la, np.random.default_rng(0),
                                       args.batch, device)

    def run(seed):
        out = rollout.expert_rollout(
            scene, la, torch.Generator(device).manual_seed(seed), pos, angle,
            tile_size=m.tile_size, n_steps=16, height=args.height,
            width=args.width)
        _sync(device)
        return out

    run(0)   # warm-up
    t0 = time.perf_counter()
    run(1)
    pair_fps = 16 * args.batch / (time.perf_counter() - t0)

    results = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "load_time_ms": round(load_time * 1e3, 1),
        "reset_time_ms": round(reset_time * 1e3, 1),
        "frame_time_ms": round(frame_time * 1e3, 2),
        "fps": round(1.0 / frame_time, 1),
        "batched_pair_fps": round(pair_fps, 1),
    }
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
