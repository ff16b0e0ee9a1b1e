"""Processes of a data-parallel run: forming the world, and a worker.

Counterpart of the JAX package's ``parallel/multihost.py``.  One process
drives one device.  ``init_world`` forms the ``torch.distributed`` group
from a launcher's environment (``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), from
explicit arguments, or, with neither, as a world of one rank on a free
``localhost`` port; NCCL on a card, gloo on the CPU.

``run_worker`` runs the supervised train step of ``train.supervised`` on
synthetic global batches, each rank on its rows, and returns the per-step
losses: the same on every rank, and those of one process stepping on the
global batch (``tests/test_torch_dp.py`` launches the processes).  One
invocation per process:

    python -m sim2real_lane_segment_tpu_torch.parallel.multihost \\
        --process_id 0 --num_processes 2 --coordinator 127.0.0.1:19876

``--cpu`` runs on the CPU over gloo; without it each process takes the
card of its ``--process_id``.
"""
from __future__ import annotations

import argparse
import json
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import World
from ..core.runtime import resolve_device
from .dp import warmup_collective


def free_port() -> int:
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(device=None, *, rank: int | None = None,
               world_size: int | None = None,
               init_method: str | None = None) -> tuple[World, bool]:
    """This process's ``World`` on ``device`` (default ``cuda``: the card
    of ``LOCAL_RANK``) and whether this call formed the group (the caller
    then ends it with ``close_world``).  A group formed before is used as
    it is."""
    device = resolve_device(device)
    env = os.environ
    if dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        world = World(dist.get_rank(), dist.get_world_size(), device)
        return world, False
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if init_method is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise SystemExit(f"a world of {world_size} ranks needs "
                             f"MASTER_ADDR and MASTER_PORT (torchrun sets "
                             f"them)")
    if device.type == "cuda":
        local = (int(env.get("LOCAL_RANK", rank)) if device.index is None
                 else device.index)
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        # collectives are captured inside the train step's CUDA graph; the
        # watchdog's asynchronous error handling must not query streams
        # while a capture runs
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    world = World(rank, world_size, device)
    warmup_collective(world)
    return world, True


def close_world() -> None:
    """End the group ``init_world`` formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> tuple[int, int]:
    """(rank, number of ranks) of this process: the group's where one is
    formed, else the launcher's environment, else (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)))


def global_batch(step: int, batch_size: int, height: int, width: int):
    """A synthetic global batch, the same on every process (the JAX
    worker's)."""
    rng = np.random.default_rng(1000 + step)
    images = rng.integers(0, 255, (batch_size, height, width, 3),
                          dtype=np.uint8)
    labels = rng.integers(0, 4, (batch_size, height, width), dtype=np.uint8)
    return images, labels


def run_worker(*, process_id: int | None = None,
               num_processes: int | None = None,
               coordinator: str | None = None, steps: int = 3,
               per_device_batch: int = 2, height: int = 24, width: int = 32,
               device=None) -> list[float]:
    """Form the world (``init_world``: the launcher's environment where
    ``process_id``/``num_processes`` are None), run ``steps`` train steps
    of a small FC-DenseNet on the global batches (this rank's rows), and
    return the losses."""
    from ..core.dtypes import F32_POLICY
    from ..models.tiramisu import FCDenseNet
    from ..train.supervised import SupervisedTrainer
    from .sharding import replicate_

    world, owned = init_world(
        device, rank=process_id, world_size=num_processes,
        init_method=None if coordinator is None else f"tcp://{coordinator}")
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = FCDenseNet(n_classes=4, down_blocks=(2, 2),
                               up_blocks=(2, 2), bottleneck_layers=2,
                               growth_rate=8, out_chans_first_conv=16,
                               policy=F32_POLICY)
        trainer = SupervisedTrainer(num_cls=4, height=height, width=width,
                                    model=model, device=world.device,
                                    world=world)
        replicate_(trainer.model, world)
        rows = world.rows(per_device_batch * world.size)
        losses = []
        for step in range(steps):
            images, labels = global_batch(step, per_device_batch * world.size,
                                          height, width)
            logs = trainer.train_step(
                images[rows], labels[rows], 1e-3,
                generator=torch.Generator().manual_seed(step))
            losses.append(float(logs["tr_loss"]))
    finally:
        if owned:
            close_world()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite losses {losses}")
    return losses


def main(args=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank (default: the launcher's, 0)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="the number of ranks (default: the launcher's, 1)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (default: a free localhost "
                        "port, for a world of one)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--per_device_batch", type=int, default=2)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU over gloo")
    args = p.parse_args(args)
    losses = run_worker(process_id=args.process_id,
                        num_processes=args.num_processes,
                        coordinator=args.coordinator, steps=args.steps,
                        per_device_batch=args.per_device_batch,
                        device="cpu" if args.cpu else None)
    rank, size = process_index()
    print(json.dumps({"process_id": (rank if args.process_id is None
                                     else args.process_id),
                      "num_processes": (size if args.num_processes is None
                                        else args.num_processes),
                      "losses": losses}))


if __name__ == "__main__":
    main()
