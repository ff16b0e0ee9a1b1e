"""Where a data-parallel step's tensors live: one rank's rows of a global
batch, the global batch gathered from the ranks, and replicated weights.

Counterpart of the JAX package's ``parallel/sharding.py``: the batch axis
is split over the ranks, parameters are replicated.  The model is a
1-10M-parameter CNN, so data parallelism is the whole strategy; the JAX
module's optional ``model`` axis (channel-sharded conv kernels, off by
default there) has no counterpart.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..core.mesh import World


def rank_rows(x: torch.Tensor, world: World) -> torch.Tensor:
    """This rank's contiguous rows of the global batch ``x``."""
    return x[world.rows(x.shape[0])]


def gather_rows(x: torch.Tensor, world: World) -> torch.Tensor:
    """The global batch from every rank's rows ``x``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(world.size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


@torch.no_grad()
def replicate_(module: nn.Module, world: World) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's, in
    place."""
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, src=0)
