"""The data-parallel world: the processes of one run, one device each.

Counterpart of the JAX package's ``core/mesh.py``.  There a
``jax.sharding.Mesh`` lays a host's devices (and, under
``jax.distributed``, every host's) along a ``data`` axis.  In PyTorch's
idiom one process drives one device, so the port's mesh is a
``torch.distributed`` process group (the default one) and its ranks are
the data axis: ``World`` names this process's rank, the number of ranks
and the device the rank drives.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class World:
    rank: int
    size: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n`` rows
        (``n`` a multiple of ``size``)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)
