"""Behaviour-cloning imitation learning (reference
learning/imitation/pytorch/: a 4-conv CNN regressing the expert's actions
with an L2 loss, train_imitation.py:62-93, model.py:6-48).

Counterpart of the JAX package's ``learning/imitation.py``:
demonstrations come from batched expert rollouts on the device
(``sim.rollout``), and a train step is SGD with momentum 0.9 on the MSE
of a batch of (obs, action) pairs.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.runtime import resolve_device
from . import SameConv2d, flatten_nhwc, flax_init_, frames_nchw, same_out

CONVS = ((32, 2), (32, 2), (64, 2), (64, 1))   # (features, stride), 4x4


class PolicyCNN(nn.Module):
    """Small conv policy: (B, 60, 80, 3) RGB -> (velocity, steering) in
    [-1, 1]."""

    def __init__(self, n_actions: int = 2, obs_hw=(60, 80)):
        super().__init__()
        h, w = obs_hw
        c = 3
        for i, (feat, stride) in enumerate(CONVS):
            setattr(self, f"Conv_{i}", SameConv2d(c, feat, 4, stride))
            c, h, w = feat, same_out(h, stride), same_out(w, stride)
        self.Dense_0 = nn.Linear(h * w * c, 256)
        self.Dense_1 = nn.Linear(256, n_actions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = frames_nchw(x)
        for i in range(len(CONVS)):
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
        x = torch.relu(self.Dense_0(flatten_nhwc(x)))
        return torch.tanh(self.Dense_1(x))


class ImitationLearner:
    """A ``PolicyCNN`` on ``device`` (``cuda`` unless the caller asks
    for the CPU) with its optimizer: SGD at ``lr``,
    momentum 0.9 (optax.sgd's trace: no dampening, not Nesterov).  The
    model holds the weights, so the learner is the whole state."""

    def __init__(self, lr: float = 1e-4, obs_hw: tuple[int, int] = (60, 80),
                 seed: int = 0, device=None):
        self.obs_hw = obs_hw
        self.device = resolve_device(device)
        self.model = PolicyCNN(obs_hw=obs_hw)
        flax_init_(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=lr,
                                   momentum=0.9)

    def train_step(self, obs: torch.Tensor,
                   actions: torch.Tensor) -> torch.Tensor:
        """One step on a batch; returns the loss before the update."""
        pred = self.model(obs.to(self.device))
        loss = torch.mean((pred - actions.to(self.device)) ** 2)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    @torch.no_grad()
    def predict(self, obs: torch.Tensor) -> torch.Tensor:
        return self.model(obs.to(self.device))
