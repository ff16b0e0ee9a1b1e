"""Optimizers in the order of the JAX package's ``optax`` chains, with the
learning rate given per step.

Counterparts of ``sim2real_lane_segment_tpu.train.optim``:

- ``AdamW`` (``adamw`` plus ``apply_updates``): ``scale_by_adam``
  (bias-corrected moments, ``u = m_hat / (sqrt(v_hat) + eps)``), then
  ``add_decayed_weights`` (``u += wd * p``), then ``p -= lr * u``;
- ``SGDNesterov`` (``sgd_nesterov`` plus ``apply_updates`` with per-leaf
  factors): torch's SGD(momentum, nesterov=True, weight_decay), ``g' = g +
  wd * p``, ``buf = mu * buf + g'``, ``u = g' + mu * buf``, ``p -= lr_p *
  u`` with one learning rate per parameter (``lr_factors`` is the
  counterpart of ``lr_factor_tree``).

The learning rate is an argument of ``step`` rather than part of the
optimizer, so a schedule never rebuilds it.  Weight decay applies to
every parameter, as in the JAX chains.

The step count, both bias corrections, the learning rates and the weight
decay are tensors on the parameters' device, read by the update there: a
CUDA graph that captures ``step`` replays it with the rate and decay set
since (``set_lr``, ``set_weight_decay``) and the count it advanced
itself; ``reset`` zeroes the state in place, so a captured step serves a
fresh run too (``cli.tune``'s trials).  ``step`` given a rate writes it into that tensor first
(``set_lr``/``set_lrs``), so eager and replayed steps run one arithmetic.
Dividing by a device tensor is a true division on every device (dividing
a CUDA tensor by a Python number multiplies by its reciprocal).

``AdamW.step`` issues each of its element-wise operations once over all
parameters of one device and dtype, as a multi-tensor (``torch._foreach_*``)
call, in the order of the per-tensor arithmetic; so a step issues the same
few operations however many parameter tensors the model has.
``counts["optim_ops"]`` counts the operations ``AdamW.step`` issued since
``reset_counts``, a multi-tensor call as one (``train.graphs.StepGraph``
puts what its capture moved on its ``train.capture`` span).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

counts = {"optim_ops": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


class AdamW:
    def __init__(self, params: Sequence[torch.Tensor], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        device = self.params[0].device if self.params else None
        self.weight_decay = torch.tensor(weight_decay, dtype=torch.float32,
                                         device=device)
        # the count and both betas in float64: 1 - b ** count rounds to
        # float32 once, as the Python arithmetic it replaces did, and one
        # pow gives both bias corrections
        self._count = torch.zeros((), dtype=torch.float64, device=device)
        self._betas = torch.tensor([b1, b2], dtype=torch.float64,
                                   device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # the parameters' positions, grouped by device and dtype: one
        # multi-tensor call an operation a group
        groups: dict = {}
        for i, p in enumerate(self.params):
            groups.setdefault((p.device, p.dtype), []).append(i)
        self._groups = list(groups.values())

    @property
    def count(self) -> int:
        """Steps taken (reads the device)."""
        return int(self._count.item())

    def set_lr(self, lr: float) -> None:
        self.lr.fill_(lr)

    def set_weight_decay(self, wd: float) -> None:
        self.weight_decay.fill_(wd)

    def reset(self) -> None:
        """The count and both moments to zero, in place."""
        for t in self.tensors():
            t.zero_()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             lr: float | None = None) -> None:
        """One update of every parameter in place from ``grads``, at ``lr``
        (None: the rate last set)."""
        if lr is not None:
            self.set_lr(lr)
        self._count.add_(1.0)
        c1, c2 = (1.0 - torch.pow(self._betas, self._count)).to(
            torch.float32).unbind()
        for idx in self._groups:
            p, g, mu, nu = ([xs[i] for i in idx] for xs in
                            (self.params, grads, self.mu, self.nu))
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            # u = (mu / c1) / (sqrt(nu / c2) + eps)
            u = torch._foreach_div(mu, c1)
            d = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(d)
            torch._foreach_add_(d, self.eps)
            torch._foreach_div_(u, d)
            # u = u + wd * p; p = p - lr * u
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(u, self.lr)
            torch._foreach_sub_(p, u)
        # the count's add, pow, subtraction and cast; 13 calls a group
        counts["optim_ops"] += 4 + 13 * len(self._groups)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor ``step`` writes besides the parameters."""
        return [self._count, *self.mu, *self.nu]

    def state_dict(self) -> dict:
        """The step count and both moments, copied to the CPU."""
        return {"count": self.count,
                "mu": [t.to("cpu", copy=True) for t in self.mu],
                "nu": [t.to("cpu", copy=True) for t in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        """Copies the count and the moments in place, onto the parameters'
        device."""
        self._count.fill_(int(state["count"]))
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)


class SGDNesterov:
    def __init__(self, params: Sequence[torch.Tensor], weight_decay: float,
                 momentum: float = 0.9):
        self.params = list(params)
        self.momentum = momentum
        self.trace = [torch.zeros_like(p) for p in self.params]
        device = self.params[0].device if self.params else None
        self.weight_decay = torch.tensor(weight_decay, dtype=torch.float32,
                                         device=device)
        # one rate per parameter, and the host values last written there
        self.lrs = torch.zeros(len(self.params), dtype=torch.float32,
                               device=device)
        self._lr_views = list(self.lrs.unbind())
        self._lrs_set: tuple | None = None

    def set_lrs(self, lrs: Sequence[float]) -> None:
        """Write one rate per parameter; a copy only when they changed."""
        lrs = tuple(float(v) for v in lrs)
        if len(lrs) != len(self.params):
            raise ValueError(f"{len(lrs)} rates for {len(self.params)} "
                             f"parameters")
        if lrs != self._lrs_set:
            self.lrs.copy_(torch.tensor(lrs, dtype=torch.float32))
            self._lrs_set = lrs

    def set_weight_decay(self, wd: float) -> None:
        self.weight_decay.fill_(wd)

    def reset(self) -> None:
        """The momentum buffers to zero, in place."""
        for t in self.trace:
            t.zero_()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             lrs: Sequence[float] | None = None) -> None:
        """One update of every parameter in place; ``lrs`` holds one
        learning rate per parameter (None: the rates last set)."""
        if lrs is not None:
            self.set_lrs(lrs)
        mu = self.momentum
        for p, g, buf, lr in zip(self.params, grads, self.trace,
                                 self._lr_views, strict=True):
            g = g + self.weight_decay * p
            buf.mul_(mu).add_(g)
            p.sub_(lr * (g + mu * buf))

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor ``step`` writes besides the parameters."""
        return list(self.trace)

    def state_dict(self) -> dict:
        """The momentum buffers, copied to the CPU."""
        return {"trace": [t.to("cpu", copy=True) for t in self.trace]}

    def load_state_dict(self, state: dict) -> None:
        """Copies the buffers in place, onto the parameters' device."""
        for dst, src in zip(self.trace, state["trace"], strict=True):
            dst.copy_(src)


def lr_factors(named_params, factor_fn: Callable[[str], float]
               ) -> list[float]:
    """One learning-rate factor per parameter from its name (the
    counterpart of the JAX ``lr_factor_tree``)."""
    return [float(factor_fn(name)) for name, _ in named_params]
