"""Demo-video inference CLI, the reference ``makeDemoVideo.py``, batched.

Counterpart of the JAX package's ``cli/make_demo_video.py``, with its
interface (reference makeDemoVideo.py:73-84): ``-t/--module_type`` (``MME``
selects the MME trainer), ``--checkpointPath`` (``.pt``, or the JAX
package's ``.msgpack``/``.npz``), ``--videoIns``/``--videoOuts``,
``--batch_size`` (64), ``--arch`` and ``--fused``:

    python -m sim2real_lane_segment_tpu_torch.cli.make_demo_video \\
        -t baseline --checkpointPath best_weights.pt --arch 67 --fused \\
        --videoIns drive.avi --videoOuts demo.avi

Each output is the input at 160x120 (cv2's LANCZOS4,
``ops.resize.resize_lanczos4_u8``) with the predicted classes painted in
(``cli.test.OVERLAY_BGR``).  Videos are PNG-in-AVI files (fourcc
``MPNG``, ``data/videoio.py``), lossless and read by cv2, not the JAX
package's FFV1, which this port neither writes nor reads.

The reference ran a batch-1 forward per frame; here frames stream in
batches of ``--batch_size``: a reader thread decodes the next batch while
the device resizes, predicts (through the fused FC-DenseNet forward, K4,
with ``--fused``, else the plain module) and paints the current one, and
a writer thread encodes.  Runs on the card unless ``main`` is given
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from ..core import runtime
from . import common
from .test import ARCHES, OVERLAY_BGR, load_trainer_and_state

log = logging.getLogger(__name__)


def _timed(it, stats: dict, key: str):
    """``it``'s items, the seconds spent producing them added to
    ``stats[key]``."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            stats[key] += time.perf_counter() - t0
        yield item


def predict_video(input_video: str, output_video: str, trainer,
                  batch_size: int = 64, predict=None) -> dict:
    """Writes ``input_video`` with ``predict``'s classes painted in
    (default ``trainer.predict_step``) to ``output_video``; returns
    {"frames", "seconds" (wall), "decode_s" (the reader thread),
    "device_s" (resize, predict and paint, up to the frames on the host),
    "encode_s" (the writer thread)}."""
    from ..data import videoio
    from ..data.prefetch import background_batches
    from ..ops.resize import resize_lanczos4_u8

    predict = predict or trainer.predict_step
    h, w = trainer.cfg.height, trainer.cfg.width
    dev = trainer.device
    lut = torch.zeros(256, 3, dtype=torch.uint8)
    for cls, color in OVERLAY_BGR.items():
        lut[cls] = torch.tensor(color, dtype=torch.uint8)
    lut = lut.to(dev)
    painted = torch.zeros(256, dtype=torch.bool)
    painted[list(OVERLAY_BGR)] = True
    painted = painted.to(dev)

    stats = {"frames": 0, "decode_s": 0.0, "device_s": 0.0}
    t_start = time.perf_counter()
    with videoio.AsyncVideoWriter(output_video, frame_size=(w, h),
                                  fps=videoio.fps_of(input_video)) as wr:
        for frames in background_batches(lambda: _timed(
                videoio.read_frames(input_video, batch_size), stats,
                "decode_s"), size=2):
            t0 = time.perf_counter()
            x = torch.from_numpy(frames).to(dev)
            pred = predict(x).long()
            out = resize_lanczos4_u8(x, h, w)
            out = torch.where(painted[pred][..., None], lut[pred], out)
            out = out.cpu().numpy()
            stats["device_s"] += time.perf_counter() - t0
            wr.write(out)
            stats["frames"] += len(out)
    stats["encode_s"] = wr.seconds
    stats["seconds"] = time.perf_counter() - t_start
    return stats


def main(args=None, device=None) -> dict:
    """Returns ``predict_video``'s numbers summed over the videos."""
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--module_type", required=True,
                   choices=["baseline", "sandt", "hm", "CycleGAN", "MME"])
    p.add_argument("--checkpointPath", type=str, required=True)
    p.add_argument("--videoIns", type=str, nargs="+", required=True)
    p.add_argument("--videoOuts", type=str, default=["./demoVideo.avi"],
                   nargs="+")
    p.add_argument("-b", "--batch_size", type=int, default=64)
    p.add_argument("--arch", choices=ARCHES, default="67")
    p.add_argument("--fused", action="store_true",
                   help="predict through the fused FC-DenseNet forward "
                        "(the K4 kernels on the card)")
    args = p.parse_args(args)
    runtime.set_float32_precision()
    if len(args.videoIns) != len(args.videoOuts):
        p.error("--videoIns and --videoOuts need as many paths each")

    module_type = "mme" if args.module_type == "MME" else args.module_type
    trainer = load_trainer_and_state(module_type, args.checkpointPath,
                                     arch=args.arch, device=device)
    predict = (trainer.predict_step_fused if args.fused
               else trainer.predict_step)
    total: dict = {}
    for vin, vout in zip(args.videoIns, args.videoOuts):
        if os.path.exists(vout):
            os.remove(vout)
        st = predict_video(vin, vout, trainer, args.batch_size, predict)
        log.info("%s -> %s: %d frames in %.2f s (decode %.2f s, device "
                 "%.2f s, encode %.2f s)", vin, vout, st["frames"],
                 st["seconds"], st["decode_s"], st["device_s"],
                 st["encode_s"])
        for k, v in st.items():
            total[k] = total.get(k, 0) + v
    return total


if __name__ == "__main__":
    main()
