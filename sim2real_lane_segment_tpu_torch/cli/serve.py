"""Streaming inference server CLI.

Serves a segmentation model behind the batch-aggregating ZMQ front end
(``serving.py``), with the flags of the JAX package's ``cli/serve.py``:

    python -m sim2real_lane_segment_tpu_torch.cli.serve \\
        --checkpointPath artifacts/lanenet_lite_sim.msgpack --port 8903

``--arch lite`` (the default) serves LaneNetLite; ``--int8`` serves it
quantized to int8 (``models.lanenet_int8``), and ``--int8 --fused``
through kernel K6 (``models.lanenet_fused``), calibrated on the PNGs of
``--calib_dir`` (any size, resized with cv2's LANCZOS4 as the JAX CLI
resizes them) or, without it, on 16 frames of
``np.random.default_rng(0)`` noise as the JAX CLI does.  ``--fused``
alone runs the FC-DenseNet archs through the fused dense-block kernels
(``models.tiramisu_fused``); LaneNetLite has no fused float forward and
runs its plain module.  Weights are a ``.pt`` state dict, a Flax
``.msgpack`` file or an ``.npz`` of flattened Flax variables.
"""
from __future__ import annotations

import argparse
import glob
import logging

import numpy as np
import torch

from ..core import runtime
from ..core.tracing import span
from . import common

log = logging.getLogger(__name__)


def calibration_frames(args, device) -> torch.Tensor:
    """uint8 (n, height, width, 3) frames on ``device`` for the int8
    activation scales: the first 64 PNGs of ``--calib_dir`` (BGR, any
    size), each resized with cv2's LANCZOS4 (``ops.resize.
    resize_lanczos4_u8``; a frame already at the size comes back
    unchanged, as cv2 copies it), or 16 frames of seeded noise."""
    if not args.calib_dir:
        log.warning("no --calib_dir: calibrating int8 on synthetic noise")
        return torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, (16, args.height, args.width, 3), dtype=np.uint8)).to(
                device)
    from ..data.png import read_png
    from ..ops.resize import resize_lanczos4_u8

    paths = sorted(glob.glob(f"{args.calib_dir}/*.png"))[:64]
    if not paths:
        raise FileNotFoundError(f"no PNG in --calib_dir {args.calib_dir}")
    log.info("calibrating int8 scales on %d frames from %s", len(paths),
             args.calib_dir)
    return torch.stack([resize_lanczos4_u8(
        torch.from_numpy(read_png(p)).to(device), args.height, args.width)
        for p in paths])


def _to_host(masks: torch.Tensor) -> np.ndarray:
    """The class maps as host numpy: ``.cpu()`` waits for the forward's
    tail on a card, then copies back (the ``serve.download`` span)."""
    with span("serve.download"):
        return masks.cpu().numpy()


def build_predict_fn(args, device=None):
    """Returns (predict_fn, height, width): uint8 NHW3 numpy -> uint8 NHW
    numpy.  ``device`` defaults to ``cuda`` and raises without a card.
    ``main`` serves what this returns."""
    from .test import load_trainer_and_state

    runtime.set_float32_precision()

    trainer = load_trainer_and_state(
        args.module_type, args.checkpointPath, num_cls=args.num_cls,
        arch=args.arch, height=args.height, width=args.width, device=device)
    if not args.int8:
        predict = (trainer.predict_step_fused if getattr(args, "fused", False)
                   else trainer.predict_step)
        return (lambda frames: _to_host(predict(frames)), args.height,
                args.width)

    if args.arch != "lite":
        raise SystemExit("--int8 requires --arch lite (models/lanenet_int8)")
    from ..models.lanenet_fused import fused_int8_serve
    from ..models.lanenet_int8 import int8_apply, quantize_lanenet
    from ..ops.augment import eval_batch

    def normalized(frames):  # NHWC, as the JAX int8 functions take
        return eval_batch(trainer._to_device(frames), None, trainer.cfg,
                          with_labels=False)[0]

    qn = quantize_lanenet(trainer.model, normalized(
        calibration_frames(args, trainer.device)))
    if getattr(args, "fused", False):
        def predict(frames):
            return fused_int8_serve(qn, trainer._to_device(frames),
                                    cfg=trainer.cfg)
    else:
        @torch.inference_mode()
        def predict(frames):
            return torch.argmax(int8_apply(qn, normalized(frames)),
                                dim=-1).to(torch.uint8)

    return lambda frames: _to_host(predict(frames)), args.height, args.width


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpointPath", required=True,
                   help=".pt state dict, Flax .msgpack weights, or .npz of "
                        "flattened Flax variables")
    p.add_argument("--module_type", default="baseline",
                   choices=["baseline", "sandt", "hm", "CycleGAN", "mme"])
    p.add_argument("--arch", default="lite",
                   choices=["67", "67r", "57", "103", "tiny", "lite", "encdec"])
    p.add_argument("--num_cls", type=int, default=4)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--fused", action="store_true",
                   help="serve FC-DenseNet archs through the fused "
                        "dense-block kernels, and --int8 through kernel K6")
    p.add_argument("--int8", action="store_true",
                   help="serve the PTQ int8 path (lite arch only)")
    p.add_argument("--calib_dir", default=None,
                   help="dir of BGR PNGs for int8 activation calibration, "
                        "resized to --height x --width (LANCZOS4)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8903)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_wait_ms", type=float, default=4.0)
    return p.parse_args(argv)


def main(argv=None) -> None:
    common.setup_logging()
    args = parse_args(argv)

    from ..serving import BatchingEngine, serve_inference

    predict_fn, h, w = build_predict_fn(args)
    engine = BatchingEngine(predict_fn, height=h, width=w,
                            max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms)
    try:
        serve_inference(engine, host=args.host, port=args.port)
    finally:
        engine.close()


if __name__ == "__main__":
    main()
