"""Streaming inference server CLI.

Serves a segmentation model behind the batch-aggregating ZMQ front end
(``serving.py``), with the flags of the JAX package's ``cli/serve.py``:

    python -m sim2real_lane_segment_tpu_torch.cli.serve \\
        --checkpointPath weights.pt --arch 67 --fused --port 8903

``--fused`` runs the FC-DenseNet archs through the fused dense-block
kernels (``models.tiramisu_fused``); without it the plain module runs.
Weights are a ``.pt`` state dict or an ``.npz`` of flattened Flax
variables.  ``--int8`` (the PTQ LaneNetLite path) is not yet ported.
"""
from __future__ import annotations

import argparse
import logging

from . import common

log = logging.getLogger(__name__)


def build_predict_fn(args, device=None):
    """Returns (predict_fn, height, width): uint8 NHW3 numpy -> uint8 NHW
    numpy.  ``device`` defaults to ``cuda`` and raises without a card."""
    if args.int8:
        raise NotImplementedError("--int8 serving is not yet ported to "
                                  "PyTorch")
    from .test import load_trainer_and_state

    trainer = load_trainer_and_state(
        args.module_type, args.checkpointPath, num_cls=args.num_cls,
        arch=args.arch, height=args.height, width=args.width, device=device)
    predict = (trainer.predict_step_fused if getattr(args, "fused", False)
               else trainer.predict_step)
    # .cpu() waits for the device: the engine gets host numpy
    return (lambda frames: predict(frames).cpu().numpy(),
            args.height, args.width)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpointPath", required=True,
                   help=".pt state dict or .npz of flattened Flax variables")
    p.add_argument("--module_type", default="baseline",
                   choices=["baseline", "sandt", "hm", "CycleGAN", "mme"])
    p.add_argument("--arch", default="lite",
                   choices=["67", "67r", "57", "103", "tiny", "lite", "encdec"])
    p.add_argument("--num_cls", type=int, default=4)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--fused", action="store_true",
                   help="serve FC-DenseNet archs through the fused "
                        "dense-block kernels")
    p.add_argument("--int8", action="store_true",
                   help="serve the PTQ int8 path (not yet ported)")
    p.add_argument("--calib_dir", default=None,
                   help="PNG dir for int8 activation calibration")
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
