"""Data-parallel training over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/dp.py``.  ``cli.train --dp``
runs one process per device (the JAX multi-host shape): each rank reads
its own shard of the deterministic samplers (``data.samplers.shard``) at
the per-process ``--batch_size``, the parameters start equal on every rank
(``sharding.replicate_``), and every step computes what one process would
compute on the global batch, the concatenation of the ranks' batches:

- BatchNorm's batch statistics are over the global batch: each rank's
  per-channel mean and mean of squares (float32) are averaged over the
  ranks (``all_mean``; the ranks hold equal batches), and so are their
  cotangents in the backward;
- the losses are over the global batch: the class weights come from the
  global class counts and each rank differentiates its share of the global
  loss (the share of a mean is the local mean over the world size);
- the shares' gradients are summed over the ranks (``reduce_grads``), so
  every rank applies the same update;
- the draws are the global batch's (``sharding.rank_rows``), so the
  dropout masks and augmentation match a one-process run at the global
  batch.

The collectives run where the statistics and losses are computed
(``models.tiramisu.batch_stats``, ``train.losses``), which read the world
that a step runs in (``active``, ``current``).  Autograd runs a card's
backward on a thread of its own, which does not see the caller's context,
so a Function whose backward computes statistics keeps the world it ran
its forward in (``tiramisu_train_fused.FusedBlock``, the ``67r``
checkpoint).  Without a world every helper is the identity, and a world
of one rank computes the same values bit for bit: its collectives copy,
and the shares divide by one.
"""
from __future__ import annotations

import contextlib
import contextvars
import logging

import torch
import torch.distributed as dist

from ..core.mesh import World

log = logging.getLogger(__name__)

_active: contextvars.ContextVar = contextvars.ContextVar("world",
                                                         default=None)


def resolve_dp(dp: str | None, world_size: int) -> bool:
    """``--dp`` -> whether to run data-parallel.  'off'/None/'0': no;
    'auto': over the world of the launch (one rank without a launcher);
    an integer: over a world of exactly that many ranks."""
    if dp in (None, "off", "0"):
        return False
    if dp == "auto":
        return True
    n = int(dp)
    if n != world_size:
        raise SystemExit(f"--dp {n}: the launch holds {world_size} ranks "
                         f"(one process per device)")
    return True


def current() -> World | None:
    """The world the running step is data-parallel over, or None."""
    return _active.get()


@contextlib.contextmanager
def active(world: World | None):
    """Run the block's steps data-parallel over ``world`` (None: alone)."""
    token = _active.set(world)
    try:
        yield
    finally:
        _active.reset(token)


class _AllSum(torch.autograd.Function):
    """The sum over the ranks; its backward sums the cotangents."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the running step's world,
    differentiably; ``x`` itself without a world."""
    return x if current() is None else _AllSum.apply(x)


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks: a global-batch mean from the ranks'
    local means."""
    world = current()
    return x if world is None else _AllSum.apply(x) / world.size


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a global-batch mean whose local mean is ``x``:
    ``all_sum(share(x))`` is the global mean."""
    world = current()
    return x if world is None else x / world.size


def reduce_grads(grads) -> list:
    """The gradients summed over the ranks in one collective."""
    if current() is None:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return out


def warmup_collective(world: World) -> None:
    """One all-reduce while every rank is in step, right after the group
    forms: it creates the communicator (NCCL's lazily, at the first
    collective) before the first train step and any graph capture."""
    x = torch.ones(1, device=world.device)
    dist.all_reduce(x)
    if int(x.item()) != world.size:
        raise RuntimeError(f"collective warm-up summed {x.item()} over "
                           f"{world.size} ranks")
    log.info("data parallelism: rank %d of %d on %s", world.rank,
             world.size, world.device)
