"""DDPG reinforcement-learning demo CLI (reference
learning/reinforcement/pytorch/train_reinforcement.py): env interaction
with exploration noise, a replay buffer, actor/critic updates, periodic
evaluation, the actor's weights saved.

Counterpart of the JAX package's ``cli/train_reinforcement.py``:
``DuckietownEnv`` at 160x120 without domain randomization, its frames
shrunk to the policy's 60x80 with cv2's INTER_LINEAR
(``ops.resize.resize_linear_u8``); ``--start_timesteps`` uniformly random
actions, then the actor's with Gaussian noise; a DDPG step a timestep
once the buffer holds a batch; ``evaluate_policy`` every
``--eval_freq`` timesteps:

    python -m sim2real_lane_segment_tpu_torch.cli.train_reinforcement \\
        --max_timesteps 500 --out ddpg_actor.pt

Runs on the card unless ``main`` is given ``device="cpu"``; ``--out`` is
a torch state dict that ``cli.enjoy reinforcement`` loads.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..core import runtime
from ..ops.resize import resize_linear_u8
from . import common

log = logging.getLogger(__name__)

CAMERA_HW = (120, 160)


def shrink(obs: np.ndarray, obs_hw) -> np.ndarray:
    """``cv2.resize(obs, (w, h))`` (INTER_LINEAR) of one uint8 frame."""
    return resize_linear_u8(torch.from_numpy(obs), *obs_hw).numpy()


def evaluate_policy(env, policy, obs_hw, eval_episodes=2,
                    max_steps=100) -> float:
    """Mean return of ``policy`` ((1, H, W, 3) uint8 tensor -> (1, 2)
    actions) over ``eval_episodes`` episodes of at most ``max_steps``."""
    total = 0.0
    for _ in range(eval_episodes):
        obs = env.reset()
        for _ in range(max_steps):
            small = torch.from_numpy(shrink(obs, obs_hw))[None]
            obs, reward, done, _ = env.step(policy(small)[0].cpu().numpy())
            total += reward
            if done:
                break
    return total / eval_episodes


def main(args=None, device=None) -> dict:
    """Returns {"episode_reward": the last episode's so far, "critic_losses"
    and "actor_losses": one a DDPG step, "evals": the mean returns, "out":
    the actor's path}."""
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--max_timesteps", type=int, default=500)
    p.add_argument("--start_timesteps", type=int, default=100,
                   help="purely random exploration steps before learning")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--expl_noise", type=float, default=0.1)
    p.add_argument("--eval_freq", type=int, default=250)
    p.add_argument("--obs-height", type=int, default=60)
    p.add_argument("--obs-width", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="ddpg_actor.pt")
    args = p.parse_args(args)
    runtime.set_float32_precision()
    device = runtime.resolve_device(device)

    from ..learning.ddpg import DDPG, ReplayBuffer
    from ..sim.env import DuckietownEnv
    from ..train.checkpoint import save_weights

    obs_hw = (args.obs_height, args.obs_width)
    h, w = CAMERA_HW
    env = DuckietownEnv(map_name=args.map_name, camera_width=w,
                        camera_height=h, domain_rand=False, seed=args.seed,
                        max_steps=200, device=device)
    ddpg = DDPG(obs_hw=obs_hw, seed=args.seed, device=device)
    buf = ReplayBuffer(seed=args.seed)
    rng = np.random.default_rng(args.seed)

    obs = shrink(env.reset(), obs_hw)
    episode_reward, episode_num = 0.0, 0
    closses, alosses, evals = [], [], []
    for t in range(args.max_timesteps):
        if t < args.start_timesteps:
            action = np.array([rng.uniform(0, 1), rng.uniform(-1, 1)],
                              np.float32)
        else:
            action = ddpg.select_action(
                torch.from_numpy(obs)[None])[0].cpu().numpy()
            action = action + rng.normal(0, args.expl_noise, 2)
            action = np.clip(action, [0, -1], [1, 1]).astype(np.float32)

        nobs, reward, done, _ = env.step(action)
        nobs = shrink(nobs, obs_hw)
        buf.add(obs, action, reward, nobs, float(done))
        obs = nobs
        episode_reward += reward

        if t >= args.start_timesteps and len(buf) >= args.batch_size:
            losses = ddpg.train_step(*(torch.from_numpy(a)
                                       for a in buf.sample(args.batch_size)))
            closses.append(losses["critic_loss"])
            alosses.append(losses["actor_loss"])

        if done:
            log.info("episode %d: reward %.1f (t=%d)", episode_num,
                     episode_reward, t)
            obs = shrink(env.reset(), obs_hw)
            episode_reward, episode_num = 0.0, episode_num + 1

        if (t + 1) % args.eval_freq == 0:
            evals.append(evaluate_policy(env, ddpg.select_action, obs_hw))
            log.info("eval @%d: avg reward %.1f", t + 1, evals[-1])

    save_weights(args.out, ddpg.actor)
    log.info("saved %s", args.out)
    return {"episode_reward": episode_reward,
            "critic_losses": [float(x) for x in closses],
            "actor_losses": [float(x) for x in alosses],
            "evals": evals, "out": args.out}


if __name__ == "__main__":
    main()
