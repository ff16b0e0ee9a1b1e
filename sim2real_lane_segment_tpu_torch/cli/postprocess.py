"""Label extraction from recorded pairs, the reference ``postprocess_v2.py``.

Counterpart of the JAX package's ``cli/postprocess.py``, with its flags
(reference postprocess_v2.py:11-15): pairs ``*_orig.avi``/``*_annot.avi``
under ``--input_dir`` become ``input/``+``label/`` video pairs
``000000.avi``, ... under ``--output_dir``; ``-dp`` deletes the processed
recordings, ``-cd`` clears the output dir first.

    python -m sim2real_lane_segment_tpu_torch.cli.postprocess \\
        -id recordings -od simData

The recordings are taken in an unseeded ``random.shuffle`` order (as the
JAX CLI does), so which pair becomes ``000000.avi`` changes from run to
run.  Frames go to the card ``--batch_size`` pairs at a time and through
``ops.labelgen.process_classes`` (kernel K5, one launch a batch; a failed
launch fails the run); the input frames and the masks, expanded to three
equal BGR channels as the reference wrote them, are written as FFV1
AVIs (``data/videoio.py``), as the JAX CLI writes them.  Runs on the
card unless ``main`` is given ``device="cpu"``, where the kernel's plain
version runs.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import shutil
from random import shuffle

import numpy as np
import torch

from ..core import runtime
from ..core.runtime import resolve_device
from . import common

log = logging.getLogger(__name__)


def process_recording(orig_fp: str, annot_fp: str, input_file: str,
                      label_file: str, batch_size: int = 32,
                      device=None) -> bool:
    """Label one recording; False (and a warning) where its two videos
    differ in length or hold no frame."""
    from ..data import videoio
    from ..ops.labelgen import process_classes_batch

    device = resolve_device(device)
    try:
        lengths = videoio.frame_count(orig_fp), videoio.frame_count(annot_fp)
    except IOError:
        log.warning("Could not open files! Continuing...")
        return False
    if lengths[0] != lengths[1]:
        log.warning("Different video length encountered! Continuing...")
        return False
    pair_iter = videoio.read_paired_frames(orig_fp, annot_fp, batch_size)

    w_in = w_lab = None
    try:
        for orig, annot in pair_iter:
            if w_in is None:
                h, w = orig.shape[1:3]
                w_in = videoio.AsyncVideoWriter(input_file, frame_size=(w, h))
                w_lab = videoio.AsyncVideoWriter(label_file,
                                                 frame_size=(w, h))
            masks = process_classes_batch(
                torch.from_numpy(orig).to(device),
                torch.from_numpy(annot).to(device)).cpu().numpy()
            w_in.write(orig)
            # the reference writes the gray mask expanded to BGR
            w_lab.write(np.repeat(masks[..., None], 3, axis=-1))
    finally:
        if w_in is not None:
            w_in.close()
            w_lab.close()
    return w_in is not None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-dp", "--delete_processed", action="store_true")
    p.add_argument("-cd", "--clear_data", action="store_true")
    p.add_argument("-id", "--input_dir",
                   default=os.path.join(os.getcwd(), "recordings"))
    p.add_argument("-od", "--output_dir",
                   default=os.path.join(os.getcwd(), "data"))
    p.add_argument("--batch_size", type=int, default=32)
    return p


def main(args=None, device=None) -> int:
    """Label every recording pair; returns the pairs done.  ``device``
    defaults to ``cuda`` and raises without a card."""
    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    device = resolve_device(device)

    if args.clear_data:
        shutil.rmtree(args.output_dir, ignore_errors=True)

    annot_list = sorted(glob.glob(os.path.join(args.input_dir,
                                               "*_annot.avi")))
    orig_list = sorted(glob.glob(os.path.join(args.input_dir,
                                              "*_orig.avi")))
    if len(annot_list) != len(orig_list):
        raise ValueError("Length mismatch! No postprocess performed.")

    raw_list = list(zip(orig_list, annot_list))
    shuffle(raw_list)

    input_dir = os.path.join(args.output_dir, "input")
    label_dir = os.path.join(args.output_dir, "label")
    os.makedirs(input_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)

    vid_counter = 0
    done = 0
    for orig_fp, annot_fp in raw_list:
        while True:
            filename = f"{vid_counter:06d}.avi"
            input_file = os.path.join(input_dir, filename)
            label_file = os.path.join(label_dir, filename)
            if not (os.path.exists(input_file) or os.path.exists(label_file)):
                break
            vid_counter += 1
        log.info("Processing recording nr. %d...", vid_counter)
        if process_recording(orig_fp, annot_fp, input_file, label_file,
                             args.batch_size, device):
            done += 1
            log.info("Processing of recording nr. %d done.", vid_counter)

    if args.delete_processed:
        shutil.rmtree(args.input_dir, ignore_errors=True)

    log.info("Post-processing finished! (%d/%d recordings)", done,
             len(raw_list))
    return done


if __name__ == "__main__":
    main()
