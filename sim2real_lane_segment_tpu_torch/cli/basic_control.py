"""Pose-based control exercise, the reference ``exercises/basic_control.py``.

Counterpart of the JAX package's ``cli/basic_control.py``: the analytic
lane-following expert (``sim/expert.py``) drives ``DuckietownEnv`` at
160x120 for ``--steps`` steps, logging pose, reward and lane position;
the "hello world" of the simulator's API.  Headless; ``--out`` records
the run to a PNG-in-AVI file (``data/videoio.py``):

    python -m sim2real_lane_segment_tpu_torch.cli.basic_control \\
        --map-name small_loop --steps 120 --out basic_control.avi

Renders on the card unless ``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging

import torch

from ..core import runtime
from . import common

log = logging.getLogger(__name__)

CAMERA_HW = (120, 160)


def main(args=None, device=None) -> float:
    """Returns the run's total reward."""
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--out", default=None)
    args = p.parse_args(args)
    runtime.set_float32_precision()

    from ..sim.env import DuckietownEnv
    from ..sim.expert import expert_action

    h, w = CAMERA_HW
    env = DuckietownEnv(map_name=args.map_name, camera_width=w,
                        camera_height=h, domain_rand=False,
                        max_steps=args.steps + 1, device=device)
    writer = None
    if args.out:
        from ..data.videoio import AsyncVideoWriter
        writer = AsyncVideoWriter(args.out, frame_size=(w, h))

    env.reset()
    total = 0.0
    step = 0
    try:
        for step in range(args.steps):
            act = expert_action(
                env.lane_arrays, env.map.tile_size,
                torch.from_numpy(env.cur_pos),
                torch.tensor(env.cur_angle, dtype=torch.float32)).numpy()
            obs, reward, done, info = env.step(act)
            total += reward
            if writer:
                writer.write(obs[..., ::-1])
            if step % 30 == 0:
                s = info["Simulator"]
                log.info("step %d: pos (%.2f, %.2f) dist %.3f reward %.2f",
                         step, *s["cur_pos"], s["lane_dist"], reward)
            if done:
                log.info("done: %s", info["msg"])
                break
    finally:
        if writer:
            writer.close()
    log.info("total reward %.1f over %d steps", total, step + 1)
    return total


if __name__ == "__main__":
    main()
