"""Interactive recorder, the reference ``manual_control.py`` rebuilt.

Counterpart of the JAX package's ``cli/manual_control.py``: arrow keys or
w/s/d/f drive, Enter starts and stops a recording, 'a' cycles the
annotation mode 0/1/2 (reference manual_control.py:96-115, 122-181), and
a recording stops by itself after 100 s, as the reference's did.  Each
recorded step writes the pixel-aligned (original, annotated) pair, the
annotated frame re-rendered with the step's DR parameters and noise, to
``<seq>_orig.avi`` and ``<seq>_annot.avi`` (FFV1 AVIs, as the JAX
package records them, ``data/videoio.py``), ready for ``cli.postprocess``:

    python -m sim2real_lane_segment_tpu_torch.cli.manual_control \\
        --map-name small_loop --output_dir recordings

The window is OpenCV's, which needs cv2 and a display; without cv2 it
exits non-zero and says so.  ``cli/datagen.py`` is the headless recorder
that makes the same files with the expert at the wheel.  Renders on the
card unless ``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Callable

import numpy as np

from ..core import runtime
from . import common

log = logging.getLogger(__name__)

RECORDING_MAX_SECONDS = 100.0
ESC, ENTER, RETURN = 27, 13, 10
# key codes -> (velocity, steering); 82-84 and 81 are cv2's arrow keys
ACTIONS = {82: (0.44, 0.0), ord("w"): (0.44, 0.0),
           84: (-0.44, 0.0), ord("s"): (-0.44, 0.0),
           81: (0.35, 1.0), ord("d"): (0.35, 1.0),
           83: (0.35, -1.0), ord("f"): (0.35, -1.0)}


def control_loop(env, key: Callable[[], int],
                 show: Callable[[np.ndarray], None], output_dir: str,
                 clock: Callable[[], float] = time.time) -> int:
    """The window's loop over a key source and a frame sink: each tick
    reads a key, steps ``env`` and shows its frame; returns the number of
    recordings started.  A recording writes pairs only while the env
    renders annotated frames (after 'a')."""
    from ..data.videoio import AsyncVideoWriter

    os.makedirs(output_dir, exist_ok=True)
    writers = None
    seq = 0
    rec_start = 0.0

    def stop_recording():
        nonlocal writers
        for w in writers:
            w.close()
        writers = None
        log.info("recording stopped")

    env.reset()
    try:
        while True:
            k = key()
            if k in (ESC, ord("q")):
                break
            action = np.array(ACTIONS.get(k, (0.0, 0.0)))
            if k == ord("a"):
                env.annotated = (env.annotated + 1) % 3
                if writers:
                    stop_recording()
                log.info("annotation mode -> %d", env.annotated)
            elif k in (ENTER, RETURN):
                if writers:
                    stop_recording()
                else:
                    size = (env.camera_width, env.camera_height)
                    writers = tuple(
                        AsyncVideoWriter(os.path.join(
                            output_dir, f"{seq:03d}_{kind}.avi"),
                            frame_size=size) for kind in ("orig", "annot"))
                    seq += 1
                    rec_start = clock()
                    log.info("recording started")

            obs, _, done, _ = env.step(action)
            if writers and env.annotated:
                orig = env.render_obs(annotated=0)
                writers[0].write(orig[..., ::-1])   # RGB -> BGR
                writers[1].write(obs[..., ::-1])
                if clock() - rec_start > RECORDING_MAX_SECONDS:
                    stop_recording()
            if done:
                if writers:
                    stop_recording()
                obs = env.reset()
            show(obs)
    finally:
        if writers:
            stop_recording()
    return seq


def main(args=None, device=None) -> int:
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map-name", default="small_loop")
    p.add_argument("--output_dir",
                   default=os.path.join(os.getcwd(), "recordings"))
    p.add_argument("--annotated", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--domain-rand", action="store_true", default=True)
    p.add_argument("--distortion", action="store_true")
    p.add_argument("--frame-rate", type=int, default=30)
    p.add_argument("--texture_pack", type=str, default=None,
                   help="photographic tile-texture directory (reference "
                        "<kind>_<i>.png / _cv layout)")
    args = p.parse_args(args)
    runtime.set_float32_precision()
    try:
        import cv2
    except ImportError:
        raise SystemExit("manual_control: the window needs cv2 (OpenCV) "
                         "and a display; cli.datagen records the same "
                         "files headless") from None

    from ..sim.env import DuckietownEnv

    env = DuckietownEnv(map_name=args.map_name, domain_rand=args.domain_rand,
                        annotated=args.annotated, distortion=args.distortion,
                        texture_pack=args.texture_pack, device=device)
    try:
        return control_loop(
            env, lambda: cv2.waitKey(1000 // args.frame_rate) & 0xFF,
            lambda f: cv2.imshow("sim2real manual control", f[..., ::-1]),
            args.output_dir)
    finally:
        cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
