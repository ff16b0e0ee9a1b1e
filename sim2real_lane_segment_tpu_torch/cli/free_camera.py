"""Free camera inspection tool (reference free_camera.py): renders the
world from a camera circling the map.

Counterpart of the JAX package's ``cli/free_camera.py``.  ``--orbit`` is
the headless route: an orbit sweep of ``--frames`` frames written as PNGs
(``data/png.py``) to ``--out_dir``:

    python -m sim2real_lane_segment_tpu_torch.cli.free_camera --orbit \\
        --frames 8 --out_dir free_camera_frames

Without ``--orbit`` it opens an OpenCV window ('a'/'d' turn the camera,
Esc or 'q' quits), which needs cv2 and a display; without cv2 it exits
non-zero and says so.  Renders on the card unless ``main`` is given
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Callable

import numpy as np
import torch

from ..core import runtime
from . import common

log = logging.getLogger(__name__)

ESC = 27
TURN = 0.1   # radians per key press


def orbit_loop(frame_at: Callable[[float], np.ndarray],
               key: Callable[[], int],
               show: Callable[[np.ndarray], None]) -> int:
    """The window's loop over a key source and a frame sink: show the
    frame at the current orbit angle, read a key ('a'/'d' turn, Esc or
    'q' quits); returns the frames shown."""
    angle, shown = 0.0, 0
    while True:
        show(frame_at(angle))
        shown += 1
        k = key()
        if k in (ESC, ord("q")):
            return shown
        if k == ord("a"):
            angle -= TURN
        elif k == ord("d"):
            angle += TURN


def main(args=None, device=None) -> int:
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--orbit", action="store_true",
                   help="headless: render an orbit sweep to --out_dir")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out_dir", default="free_camera_frames")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    args = p.parse_args(args)
    runtime.set_float32_precision()
    cv2 = None
    if not args.orbit:
        try:
            import cv2
        except ImportError:
            raise SystemExit("free_camera: the interactive window needs "
                             "cv2 (OpenCV) and a display; use --orbit to "
                             "write the frames as PNGs") from None
    device = runtime.resolve_device(device)

    from ..data.png import write_png
    from ..sim import render
    from ..sim.maps import builtin_map

    m = builtin_map(args.map_name)
    scene = render.build_scene(m, device=device)
    dr = render.DRParams.default(1, device)
    cx = m.grid_width * m.tile_size / 2
    cz = m.grid_height * m.tile_size / 2

    def frame_at(angle: float) -> np.ndarray:
        """RGB frame of a camera on a circle around the map, looking in."""
        r = max(cx, cz) * 1.1
        pos = torch.tensor([[cx + r * np.cos(angle), cz + r * np.sin(angle)]],
                           dtype=torch.float32, device=device)
        heading = np.arctan2(np.sin(angle), -np.cos(angle)) + np.pi
        return render.render_frame(
            scene, pos, torch.tensor([heading], dtype=torch.float32,
                                     device=device), dr,
            height=args.height, width=args.width)[0].cpu().numpy()

    if args.orbit:
        os.makedirs(args.out_dir, exist_ok=True)
        for i in range(args.frames):
            frame = frame_at(2 * np.pi * i / args.frames)
            write_png(os.path.join(args.out_dir, f"orbit_{i:03d}.png"),
                      frame[..., ::-1])
        log.info("wrote %d frames to %s", args.frames, args.out_dir)
        return args.frames

    try:
        orbit_loop(frame_at, lambda: cv2.waitKey(30) & 0xFF,
                   lambda f: cv2.imshow("free camera", f[..., ::-1]))
    finally:
        cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    main()
