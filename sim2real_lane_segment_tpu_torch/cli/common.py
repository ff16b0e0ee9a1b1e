"""Shared CLI plumbing: logging and the reference-compatible argument
groups of the JAX package's ``cli/common.py``."""
from __future__ import annotations

import argparse
import logging


def setup_logging(level=logging.INFO) -> None:
    logging.basicConfig(format="[%(levelname)s]: %(message)s", level=level)


def add_data_args(parser: argparse.ArgumentParser) -> None:
    """The reference's DataModule flags (dataModules.py:27-39)."""
    g = parser.add_argument_group("DataModule",
                                  "Parameters defining data handling")
    g.add_argument("--gray", action="store_true",
                   help="Convert input image to grayscale")
    g.add_argument("--width", type=int, default=160,
                   help="Resize width of input images")
    g.add_argument("--height", type=int, default=120,
                   help="Resize height of input images")
    g.add_argument("--augment", action="store_true",
                   help="Use data augmentation on training set")
    g.add_argument("-b", "--batch_size", type=int, default=32,
                   help="Input batch size")
    g.add_argument("--load2memory", action="store_true",
                   help="Pre-fetch data into memory first")
    g.add_argument("--device_cache", action="store_true",
                   help="Keep dataset splits on the device; train steps "
                        "gather their batches there and run as CUDA-graph "
                        "replays, 32 a dispatch")


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The reference's TrainingModule flags (TrainingBase.py:42-52)."""
    g = parser.add_argument_group("TrainingModule",
                                  "Parameters defining network training")
    g.add_argument("-lr", "--learningRate", type=float, default=1e-3,
                   help="Starting learning rate")
    g.add_argument("--decay", type=float, default=1e-4,
                   help="L2 weight decay value")
    g.add_argument("--lrRatio", type=float, default=1000,
                   help="Ratio of maximum and minimum of learning rate for "
                        "cosine LR scheduler")
