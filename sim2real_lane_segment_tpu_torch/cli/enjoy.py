"""Policy rollout viewer, the reference ``enjoy_imitation.py`` /
``enjoy_reinforcement.py`` demos, headless.

Counterpart of the JAX package's ``cli/enjoy.py``: loads trained
imitation (behaviour-cloned) or DDPG actor weights (the port's ``.pt``,
or the JAX CLIs' ``.msgpack``), rolls the policy in ``DuckietownEnv`` at
160x120 (frames shrunk to the policy's 60x80 with cv2's INTER_LINEAR),
reports each episode's return, and with ``--out`` writes the frames to a
PNG-in-AVI file (``data/videoio.py``):

    python -m sim2real_lane_segment_tpu_torch.cli.enjoy imitation \\
        --weights imitation_weights.pt --out enjoy.avi

Runs on the card unless ``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging

import torch

from ..core import runtime
from . import common
from .train_reinforcement import CAMERA_HW, shrink

log = logging.getLogger(__name__)


def main(args=None, device=None) -> dict:
    """Returns {"mean_return": over the episodes, "steps": env steps
    taken (frames written with --out)}."""
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["imitation", "reinforcement"])
    p.add_argument("--weights", required=True)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--episodes", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--obs-height", type=int, default=60)
    p.add_argument("--obs-width", type=int, default=80)
    p.add_argument("--out", default=None, help="write rollout video here")
    args = p.parse_args(args)
    runtime.set_float32_precision()
    device = runtime.resolve_device(device)

    from ..learning import load_policy
    from ..learning.ddpg import ActorCNN
    from ..learning.imitation import PolicyCNN
    from ..sim.env import DuckietownEnv

    h, w = CAMERA_HW
    env = DuckietownEnv(map_name=args.map_name, camera_width=w,
                        camera_height=h, domain_rand=False,
                        max_steps=args.max_steps, device=device)
    obs_hw = (args.obs_height, args.obs_width)
    net = (PolicyCNN if args.kind == "imitation" else ActorCNN)(
        obs_hw=obs_hw)
    policy = load_policy(args.weights, net).to(device).eval()

    writer = None
    if args.out:
        from ..data.videoio import AsyncVideoWriter
        writer = AsyncVideoWriter(args.out, frame_size=(w, h))

    total, steps = 0.0, 0
    try:
        for ep in range(args.episodes):
            obs = env.reset()
            ep_reward = 0.0
            for _ in range(args.max_steps):
                small = torch.from_numpy(shrink(obs, obs_hw))[None]
                with torch.no_grad():
                    action = policy(small.to(device))[0].cpu().numpy()
                obs, reward, done, _ = env.step(action)
                ep_reward += reward
                steps += 1
                if writer:
                    writer.write(obs[..., ::-1])
                if done:
                    break
            log.info("episode %d: return %.1f", ep, ep_reward)
            total += ep_reward
    finally:
        if writer:
            writer.close()
    return {"mean_return": total / args.episodes, "steps": steps}


if __name__ == "__main__":
    main()
