"""Automated data generation: expert rollouts rendered into paired videos.

Counterpart of the JAX package's ``cli/datagen.py`` (the headless
successor to the reference's interactive ``manual_control.py``
recording, which needed a person at the wheel and an 'A'-key annotation cycle,
manual_control.py:122-181, recorder.py), with its flags:

    python -m sim2real_lane_segment_tpu_torch.cli.datagen \\
        --map-name loop_dyn_duckiebots --episodes 4 --steps 256 \\
        --agents 2 --distortion --output_dir recordings

Each episode spawns ``--agents`` agents (``sim.rollout.sample_spawns``,
numpy's ``default_rng(--seed)``, the JAX CLI's spawns) and drives them
``--steps`` steps in rollouts of ``--chunk`` steps
(``sim.rollout.expert_rollout`` on the card, DR and camera noise from a
``torch.Generator`` seeded with ``--seed``).  Agent a of episode e writes
``<seq>_orig.avi`` and ``<seq>_annot.avi``, BGR frames in FFV1 AVIs
(``data/videoio.py``: the JAX package's format, lossless), ready for
``postprocess`` -> ``preprocess_db`` -> training.  Runs on the card
unless ``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import runtime
from ..core.runtime import resolve_device
from . import common

log = logging.getLogger(__name__)


class DatagenStats(NamedTuple):
    n_frames: int         # frames per stream written (pairs)
    seconds: float        # wall time of the run
    render_seconds: float  # rollouts, up to their frames on the host
    encode_seconds: float  # the writers' threads encoding and writing


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--output_dir",
                   default=os.path.join(os.getcwd(), "recordings"))
    p.add_argument("--episodes", type=int, default=4,
                   help="number of recordings (videos) to produce")
    p.add_argument("--steps", type=int, default=256,
                   help="frames per recording")
    p.add_argument("--agents", type=int, default=1,
                   help="parallel agents per rollout batch (each gets its "
                        "own video)")
    p.add_argument("--chunk", type=int, default=32,
                   help="rollout steps per call")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-domain-rand", action="store_true")
    p.add_argument("--distortion", action="store_true")
    p.add_argument("--texture_pack", type=str, default=None,
                   help="directory of photographic tile textures "
                        "(reference <kind>_<i>.png / _cv layout); renders "
                        "through the atlas path instead of procedural "
                        "shading")
    return p


def run(args=None, device=None) -> DatagenStats:
    """Record the episodes; ``device`` defaults to ``cuda`` and raises
    without a card."""
    from ..data.videoio import AsyncVideoWriter
    from ..sim import lanes, render, rollout
    from ..sim.maps import builtin_map

    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    device = resolve_device(device)
    t_start = time.perf_counter()

    m = builtin_map(args.map_name)
    scene = render.build_scene(m, args.seed, texture_pack=args.texture_pack,
                               device=device)
    lane_arrays = lanes.build_lane_arrays(m, device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    os.makedirs(args.output_dir, exist_ok=True)
    seq = 0
    n_written = 0
    render_s = encode_s = 0.0
    size = (args.width, args.height)
    for ep in range(args.episodes):
        pos, angle = rollout.sample_spawns(m, lane_arrays, rng, args.agents,
                                           device)
        writers = []
        try:
            for _ in range(args.agents):
                writers.append(tuple(
                    AsyncVideoWriter(os.path.join(
                        args.output_dir, f"{seq:03d}_{kind}.avi"),
                        frame_size=size) for kind in ("orig", "annot")))
                seq += 1
            steps_done = 0
            while steps_done < args.steps:
                t0 = time.perf_counter()
                batch = rollout.expert_rollout(
                    scene, lane_arrays, gen, pos, angle,
                    tile_size=m.tile_size, n_steps=args.chunk,
                    height=args.height, width=args.width,
                    domain_rand=not args.no_domain_rand,
                    distortion=args.distortion,
                    procedural=args.texture_pack is None)
                orig = batch.orig.cpu().numpy()   # (T, B, H, W, 3) RGB
                annot = batch.annot.cpu().numpy()
                render_s += time.perf_counter() - t0
                pos, angle = batch.pos[-1], batch.angle[-1]
                for a, (w_orig, w_annot) in enumerate(writers):
                    # the recorder wrote BGR (recorder.py:77)
                    w_orig.write(orig[:, a, :, :, ::-1])
                    w_annot.write(annot[:, a, :, :, ::-1])
                steps_done += args.chunk
                n_written += args.chunk * args.agents
        finally:
            for pair in writers:
                for w in pair:
                    w.close()
                    encode_s += w.seconds
        log.info("episode %d recorded (%d frames x %d agents)",
                 ep, args.steps, args.agents)

    seconds = time.perf_counter() - t_start
    log.info("wrote %d frame pairs into %s in %.1f s (rendering %.1f s, "
             "encoding %.1f s of thread time)", n_written, args.output_dir,
             seconds, render_s, encode_s)
    return DatagenStats(n_written, seconds, render_s, encode_s)


def main(args=None, device=None) -> int:
    """Record the episodes; returns the frame pairs written."""
    return run(args, device).n_frames


if __name__ == "__main__":
    main()
