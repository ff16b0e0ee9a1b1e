"""DDPG reinforcement learning (reference learning/reinforcement/pytorch/:
ActorCNN/CriticCNN with target networks and tau soft updates,
ddpg.py:16-223; a replay buffer with random eviction, utils.py:18-57).

Counterpart of the JAX package's ``learning/ddpg.py``.  A train step runs
in the JAX step's order: the TD target from both target nets, the
critic's Adam step, the actor's loss against the updated critic, the
actor's Adam step, then both targets soft-updated with tau.  The replay
buffer is a host-side list whose evictions and samples are the JAX
buffer's numpy draws.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..core.runtime import resolve_device
from . import SameConv2d, flatten_nhwc, flax_init_, frames_nchw, same_out

FEATURES = (32, 32, 64)   # three 4x4 convs at stride 2


def _conv_stack(module: nn.Module, obs_hw) -> int:
    """Adds ``Conv_0..2`` to ``module``; returns the flattened width."""
    h, w = obs_hw
    c = 3
    for i, feat in enumerate(FEATURES):
        setattr(module, f"Conv_{i}", SameConv2d(c, feat, 4, 2))
        c, h, w = feat, same_out(h, 2), same_out(w, 2)
    return h * w * c


def _features(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    x = frames_nchw(x)
    for i in range(len(FEATURES)):
        x = torch.relu(getattr(module, f"Conv_{i}")(x))
    return flatten_nhwc(x)


class ActorCNN(nn.Module):
    """(B, H, W, 3) frames -> (B, 2) actions: velocity in [0, 1]
    (sigmoid), steering in [-1, 1] (tanh), times ``max_action``."""

    def __init__(self, obs_hw=(60, 80), max_action: float = 1.0):
        super().__init__()
        self.max_action = max_action
        self.Dense_0 = nn.Linear(_conv_stack(self, obs_hw), 256)
        self.Dense_1 = nn.Linear(256, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.Dense_1(torch.relu(self.Dense_0(_features(self, x))))
        return torch.stack([torch.sigmoid(a[:, 0]), torch.tanh(a[:, 1])],
                           -1) * self.max_action


class CriticCNN(nn.Module):
    """(frames, actions) -> (B,) Q values; the action joins after the
    flatten."""

    def __init__(self, obs_hw=(60, 80)):
        super().__init__()
        self.Dense_0 = nn.Linear(_conv_stack(self, obs_hw) + 2, 256)
        self.Dense_1 = nn.Linear(256, 1)

    def forward(self, x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([_features(self, x), action.to(torch.float32)], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))[:, 0]


class ReplayBuffer:
    """Ring buffer with random eviction when full (utils.py:18-57)."""

    def __init__(self, max_size: int = 10000, seed: int = 0):
        self.storage: list = []
        self.max_size = max_size
        self.rng = np.random.default_rng(seed)

    def add(self, obs, action, reward, next_obs, done):
        item = (obs, action, reward, next_obs, done)
        if len(self.storage) < self.max_size:
            self.storage.append(item)
        else:
            self.storage[self.rng.integers(len(self.storage))] = item

    def sample(self, batch_size: int):
        idx = self.rng.integers(len(self.storage), size=batch_size)
        obs, act, rew, nobs, done = zip(*[self.storage[i] for i in idx])
        return (np.stack(obs), np.stack(act),
                np.asarray(rew, np.float32), np.stack(nobs),
                np.asarray(done, np.float32))

    def __len__(self):
        return len(self.storage)


class DDPG:
    """Actor, critic, their target copies and two Adam optimizers (lr
    ``lr``, optax.adam's defaults) on ``device``, ``cuda`` unless the
    caller asks for the CPU."""

    def __init__(self, obs_hw=(60, 80), lr=1e-4, gamma=0.99, tau=0.005,
                 seed: int = 0, device=None):
        self.obs_hw = obs_hw
        self.gamma, self.tau = gamma, tau
        self.device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.actor, self.critic = ActorCNN(obs_hw), CriticCNN(obs_hw)
        flax_init_(self.actor, g)
        flax_init_(self.critic, g)
        self.actor.to(self.device)
        self.critic.to(self.device)
        self.actor_target = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        self.actor_opt = torch.optim.Adam(self.actor.parameters(), lr=lr)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(), lr=lr)

    @torch.no_grad()
    def select_action(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(obs.to(self.device))

    def train_step(self, obs, action, reward, next_obs, done) -> dict:
        """One DDPG update on a batch of tensors; returns both losses
        (before their updates) as 0-dim tensors."""
        obs, action, reward, next_obs, done = (
            torch.as_tensor(a).to(self.device)
            for a in (obs, action, reward, next_obs, done))
        with torch.no_grad():
            target_q = self.critic_target(next_obs,
                                          self.actor_target(next_obs))
            y = reward + (1.0 - done) * self.gamma * target_q

        closs = torch.mean((self.critic(obs, action) - y) ** 2)
        self.critic_opt.zero_grad(set_to_none=True)
        closs.backward()
        self.critic_opt.step()

        # the actor's loss against the updated critic, whose weights take
        # no gradient here
        self.critic.requires_grad_(False)
        try:
            aloss = -torch.mean(self.critic(obs, self.actor(obs)))
            self.actor_opt.zero_grad(set_to_none=True)
            aloss.backward()
        finally:
            self.critic.requires_grad_(True)
        self.actor_opt.step()

        with torch.no_grad():
            for tgt, src in ((self.actor_target, self.actor),
                             (self.critic_target, self.critic)):
                for t, s in zip(tgt.parameters(), src.parameters()):
                    t.mul_(1 - self.tau).add_(self.tau * s)
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach()}
