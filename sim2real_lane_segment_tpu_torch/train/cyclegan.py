"""CycleGAN training: the in-framework completion of the CycleGAN regime.

Counterpart of ``sim2real_lane_segment_tpu.train.cyclegan``: two
``GeneratorResNet`` (A->B, B->A) and two PatchGAN discriminators trained
on unpaired image stacks with

- LSGAN objectives (MSE to 1/0 patch targets),
- cycle-consistency L1 x ``lambda_cyc`` (10) and identity L1 x
  ``lambda_id`` (5),
- Adam(b1 0.5, b2 0.999, eps 1e-8) at lr 2e-4 for each side (optax's
  ``adam``: ``train.optim.AdamW`` without decay),
- a 50-image replay pool per domain feeding the discriminator step.

One ``train_step`` runs in the JAX step's order: the generator loss takes
gradients through the *old* discriminators, Adam updates both
generators, then the discriminators step on the real images and the
pooled fakes.  Each side's gradients are taken with respect to its own
parameters alone (``torch.autograd.grad``).  The pools' decisions and the
epoch permutations are numpy ``default_rng`` draws with the JAX seeds, so
the two packages draw the same; the pooled images stay on the device.
Images are NCHW float32 in [-1, 1] on the trainer's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import F32_POLICY, DTypePolicy
from ..core.runtime import resolve_device
from ..models.cyclegan import Discriminator, GeneratorResNet
from .optim import AdamW


def _mse(x: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean((x - target) ** 2)


def _l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


class ImagePool:
    """50-image replay buffer: once full, with p=0.5 an incoming fake
    replaces a random stored one, which is returned in its place."""

    def __init__(self, size: int = 50, seed: int = 0):
        self.size = size
        self.items: list[torch.Tensor] = []
        self.rng = np.random.default_rng(seed)

    def query(self, fakes: torch.Tensor) -> torch.Tensor:
        if self.size == 0:
            return fakes
        out = []
        for img in fakes:
            if len(self.items) < self.size:
                self.items.append(img)
                out.append(img)
            elif self.rng.random() < 0.5:
                i = int(self.rng.integers(self.size))
                out.append(self.items[i])
                self.items[i] = img
            else:
                out.append(img)
        return torch.stack(out)


class CycleGANTrainer:
    """Owns the four networks and both optimizers on ``device`` (default
    ``cuda``; raises without a card).  Float32 by default, as the JAX
    trainer: LSGAN and InstanceNorm statistics are less stable in
    bfloat16.  The initial weights come from ``torch``'s global
    generator; seed it, or load weights, before training."""

    def __init__(self, *, num_residual_blocks: int = 9, lr: float = 2e-4,
                 lambda_cyc: float = 10.0, lambda_id: float = 5.0,
                 policy: DTypePolicy = F32_POLICY, device=None):
        self.device = resolve_device(device)
        self.lr = lr
        self.lambda_cyc = lambda_cyc
        self.lambda_id = lambda_id
        self.g_ab, self.g_ba = (
            GeneratorResNet(num_residual_blocks=num_residual_blocks,
                            policy=policy).to(self.device)
            for _ in range(2))
        self.d_a, self.d_b = (Discriminator(policy=policy).to(self.device)
                              for _ in range(2))
        self.g_params = [*self.g_ab.parameters(), *self.g_ba.parameters()]
        self.d_params = [*self.d_a.parameters(), *self.d_b.parameters()]
        self.opt_g = AdamW(self.g_params, 0.0, b1=0.5, b2=0.999)
        self.opt_d = AdamW(self.d_params, 0.0, b1=0.5, b2=0.999)

    def train_step(self, real_a: torch.Tensor, real_b: torch.Tensor,
                   pool_fake_a: torch.Tensor, pool_fake_b: torch.Tensor):
        """One step on NCHW [-1, 1] batches.  Returns ((fake_a, fake_b),
        logs): the fakes of the old generators, which the caller routes
        through the pools into the next step, and the losses as device
        scalars."""
        fake_b = self.g_ab(real_a)
        fake_a = self.g_ba(real_b)
        loss_id = 0.5 * (_l1(self.g_ab(real_b), real_b)
                         + _l1(self.g_ba(real_a), real_a))
        loss_gan = 0.5 * (_mse(self.d_b(fake_b), 1.0)
                          + _mse(self.d_a(fake_a), 1.0))
        loss_cyc = 0.5 * (_l1(self.g_ba(fake_b), real_a)
                          + _l1(self.g_ab(fake_a), real_b))
        g_total = (loss_gan + self.lambda_cyc * loss_cyc
                   + self.lambda_id * loss_id)
        g_grads = torch.autograd.grad(g_total, self.g_params)
        self.opt_g.step(g_grads, self.lr)

        loss_da = 0.5 * (_mse(self.d_a(real_a), 1.0)
                         + _mse(self.d_a(pool_fake_a), 0.0))
        loss_db = 0.5 * (_mse(self.d_b(real_b), 1.0)
                         + _mse(self.d_b(pool_fake_b), 0.0))
        d_total = 0.5 * (loss_da + loss_db)
        d_grads = torch.autograd.grad(d_total, self.d_params)
        self.opt_d.step(d_grads, self.lr)

        logs = {"loss_G": g_total, "loss_D": d_total, "loss_gan": loss_gan,
                "loss_cyc": loss_cyc, "loss_id": loss_id}
        return (fake_a.detach(), fake_b.detach()), {
            k: v.detach() for k, v in logs.items()}


def fit_cyclegan(trainer: CycleGANTrainer, images_a: np.ndarray,
                 images_b: np.ndarray, *, epochs: int = 30,
                 batch_size: int = 4, seed: int = 42, log_every: int = 0,
                 log=None) -> list[dict]:
    """Unpaired training over two NHWC float32 [-1, 1] stacks (uploaded
    to the trainer's device once).  Each epoch shuffles both domains and
    walks min(len) // batch_size steps.  Returns one row per epoch, the
    last step's losses."""
    rng = np.random.default_rng(seed)
    pool_a, pool_b = ImagePool(seed=seed), ImagePool(seed=seed + 1)
    n_steps = min(len(images_a), len(images_b)) // batch_size
    if n_steps == 0:
        raise ValueError("not enough images for one batch")
    dev = trainer.device
    stack_a, stack_b = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                        .permute(0, 3, 1, 2) for x in (images_a, images_b))
    history = []
    for epoch in range(epochs):
        ia = torch.from_numpy(rng.permutation(len(images_a))).to(dev)
        ib = torch.from_numpy(rng.permutation(len(images_b))).to(dev)
        for s in range(n_steps):
            a = stack_a[ia[s * batch_size:(s + 1) * batch_size]]
            b = stack_b[ib[s * batch_size:(s + 1) * batch_size]]
            if epoch == 0 and s == 0:
                # the pools start empty: seed them with the untrained
                # generators' fakes (no parameter update)
                with torch.no_grad():
                    pfa, pfb = trainer.g_ba(b), trainer.g_ab(a)
            # D sees the previous step's (pooled) fakes
            (pfa, pfb), logs = trainer.train_step(
                a, b, pool_a.query(pfa), pool_b.query(pfb))
        row = {k: float(v) for k, v in logs.items()}
        row["epoch"] = epoch
        history.append(row)
        if log is not None and (log_every and epoch % log_every == 0
                                or epoch == epochs - 1):
            log.info("cyclegan epoch %d: G %.4f D %.4f cyc %.4f",
                     epoch, row["loss_G"], row["loss_D"], row["loss_cyc"])
    return history
