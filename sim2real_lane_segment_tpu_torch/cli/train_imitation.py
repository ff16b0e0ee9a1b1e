"""Imitation-learning demo CLI (reference learning/imitation/pytorch/
train_imitation.py): collect expert demonstrations, behaviour-clone the
CNN policy, save its weights.

Counterpart of the JAX package's ``cli/train_imitation.py``: each of
``--episodes`` episodes spawns one agent (numpy's ``default_rng(--seed)``,
the JAX CLI's spawns) and renders a ``--steps``-step expert rollout at
the policy's 60x80 (``sim.rollout.expert_rollout``, domain randomized);
the expert's action at each pose is the label.  Then ``--epochs`` epochs
of SGD over shuffled batches (``learning.imitation.ImitationLearner``):

    python -m sim2real_lane_segment_tpu_torch.cli.train_imitation \\
        --episodes 4 --steps 64 --epochs 10 --out imitation_weights.pt

Runs on the card unless ``main`` is given ``device="cpu"``; ``--out`` is
a torch state dict that ``cli.enjoy imitation`` loads.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..core import runtime
from . import common

log = logging.getLogger(__name__)


def main(args=None, device=None) -> dict:
    """Returns {"frames": demonstrations, "epoch_losses": the mean loss
    of each epoch, "out": the weights' path}."""
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--episodes", type=int, default=4)
    p.add_argument("--steps", type=int, default=64, help="steps per episode")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out", default="imitation_weights.pt")
    p.add_argument("--obs-height", type=int, default=60)
    p.add_argument("--obs-width", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(args)
    runtime.set_float32_precision()
    device = runtime.resolve_device(device)

    from ..learning.imitation import ImitationLearner
    from ..sim import lanes, render, rollout
    from ..sim.expert import expert_action
    from ..sim.maps import builtin_map
    from ..train.checkpoint import save_weights

    m = builtin_map(args.map_name)
    scene = render.build_scene(m, args.seed, device=device)
    la = lanes.build_lane_arrays(m, device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device).manual_seed(args.seed)

    # ---- demonstrations, rendered at the policy's resolution
    all_obs, all_act = [], []
    for _ in range(args.episodes):
        pos, angle = rollout.sample_spawns(m, la, rng, 1, device)
        batch = rollout.expert_rollout(
            scene, la, gen, pos, angle, tile_size=m.tile_size,
            n_steps=args.steps, height=args.obs_height,
            width=args.obs_width, domain_rand=True)
        all_obs.append(batch.orig[:, 0])
        all_act.append(expert_action(la, m.tile_size, batch.pos[:, 0],
                                     batch.angle[:, 0]))
    obs = torch.cat(all_obs)
    act = torch.cat(all_act).to(torch.float32)
    n = len(obs)
    log.info("collected %d demonstration frames", n)

    # ---- behaviour cloning
    learner = ImitationLearner(lr=args.lr,
                               obs_hw=(args.obs_height, args.obs_width),
                               seed=args.seed, device=device)
    epoch_losses = []
    for epoch in range(args.epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        losses = [learner.train_step(obs[idx], act[idx])
                  for idx in perm[:n - n % args.batch_size].split(
                      args.batch_size)]
        epoch_losses.append(float(torch.stack(losses).mean())
                            if losses else float("nan"))
        log.info("epoch %d: bc loss %.5f", epoch, epoch_losses[-1])

    save_weights(args.out, learner.model)
    log.info("saved %s", args.out)
    return {"frames": n, "epoch_losses": epoch_losses, "out": args.out}


if __name__ == "__main__":
    main()
