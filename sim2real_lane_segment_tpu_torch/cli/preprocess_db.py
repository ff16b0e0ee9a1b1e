"""The dataset-tree CLI, the reference ``utils/preprocessDatabase.py``.

Counterpart of the JAX package's ``cli/preprocess_db.py``, with its flags
(reference preprocessDatabase.py:229-251): ``--dbType sim|real``,
``--single_sim_dir``, ``--dataPath``, ``--train_ratio``, ``--grayscale``,
``--resize``, ``--width``, ``--height``; it seeds ``random.seed(42)``.

    python -m sim2real_lane_segment_tpu_torch.cli.preprocess_db \\
        --dbType sim --dataPath simData

It explodes the paired videos under ``input/``+``label/`` (FFV1 AVIs,
or the port's older PNG-in-AVI, ``data/videoio.py``) into numbered PNGs,
the labels converted to gray, then shuffle-splits sim data 70/15/15 into train/valid/test (or real data
into train/test and re-nests ``unlabelled/input``), moving files into the
reference's directory contract.  The gray conversion and the optional
``--grayscale``/``--resize`` transform are cv2's arithmetic
(``ops/resize.py``: ``COLOR_BGR2GRAY``, INTER_LINEAR, INTER_NEAREST for
labels), run on each batch of frames on the card unless ``main`` is given
``device="cpu"``; the PNGs hold the pixels cv2 would write.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import shutil
from random import seed, shuffle

import numpy as np
import torch

from ..core import runtime
from ..core.runtime import resolve_device
from ..data import videoio
from ..data.png import write_png
from ..ops.resize import bgr_to_gray_u8, resize_linear_u8, resize_nearest_u8
from . import common

log = logging.getLogger(__name__)

BATCH = 64
# zlib level of the PNGs (lossless at any level; the videos' level, about
# a sixth of level 6's time a 480x640 frame)
PNG_LEVEL = videoio.ZLIB_LEVEL


class GrayscaleResizeTransform:
    """Optional grayscale + resize (nearest for labels) at explode time
    (reference preprocessDatabase.py:206-226), on batches of tensors."""

    def __init__(self, grayscale: bool, new_res: tuple | None = None):
        self.grayscale = grayscale
        self.new_res = new_res

    def __call__(self, img, label):
        """``img`` (N, H, W, 3) BGR, ``label`` (N, H, W) gray or None."""
        w_h = self.new_res
        if img is not None:
            if self.grayscale:
                img = bgr_to_gray_u8(img)
            if w_h is not None:
                img = (resize_linear_u8(img[..., None], w_h[1], w_h[0])[..., 0]
                       if self.grayscale else
                       resize_linear_u8(img, w_h[1], w_h[0]))
        if label is not None and w_h is not None:
            label = resize_nearest_u8(label[..., None], w_h[1], w_h[0])[..., 0]
        return img, label


def videos2images(directory: str, transform=None, have_labels: bool = True,
                  delete_processed: bool = False, device=None) -> int:
    """Explode paired videos into numbered PNG frames."""
    input_dir = os.path.join(directory, "input")
    label_dir = os.path.join(directory, "label") if have_labels else None
    if not os.path.isdir(input_dir) or (have_labels
                                        and not os.path.isdir(label_dir)):
        raise FileNotFoundError("Unexpected directory structure!")
    device = resolve_device(device)

    input_vids = sorted(glob.glob(os.path.join(input_dir, "*.avi")))
    label_vids = (sorted(glob.glob(os.path.join(label_dir, "*.avi")))
                  if have_labels else None)
    if have_labels and len(input_vids) != len(label_vids):
        raise RuntimeError("Different number of input and target videos!")
    if not input_vids:
        log.info("%s: No data found.", directory)
        return 0

    img_counter = 0
    for k, input_vid in enumerate(input_vids):
        label_vid = label_vids[k] if have_labels else None
        try:
            lengths = [videoio.frame_count(v) for v in (input_vid, label_vid)
                       if v is not None]
        except IOError:
            log.warning("Could not open file! Continuing...")
            continue
        if len(set(lengths)) > 1:
            log.warning("Different video length encountered at: %s! "
                        "Continuing...", input_vid)
            continue
        if have_labels:
            batches = videoio.read_paired_frames(input_vid, label_vid, BATCH)
        else:
            batches = ((b, None) for b in videoio.read_frames(input_vid,
                                                              BATCH))
        for inputs, labels in batches:
            img = torch.from_numpy(inputs).to(device)
            lab = (bgr_to_gray_u8(torch.from_numpy(labels).to(device))
                   if have_labels else None)
            if transform is not None:
                img, lab = transform(img, lab)
            img = img.cpu().numpy()
            lab = lab.cpu().numpy() if lab is not None else None
            for i in range(len(img)):
                filename = f"{img_counter:06d}.png"
                write_png(os.path.join(input_dir, filename), img[i],
                          level=PNG_LEVEL)
                if have_labels:
                    write_png(os.path.join(label_dir, filename), lab[i],
                              level=PNG_LEVEL)
                img_counter += 1
        if delete_processed:
            os.remove(input_vid)
            if label_vid:
                os.remove(label_vid)

    log.info("%s: images generated: %d", directory, img_counter)
    return img_counter


def _split_move(data_path: str, set_specs: list[tuple[str, list]]) -> None:
    for set_name, img_set in set_specs:
        set_path = os.path.join(data_path, set_name)
        os.makedirs(os.path.join(set_path, "input"))
        os.makedirs(os.path.join(set_path, "label"))
        for i, (input_img, label_img) in enumerate(img_set):
            filename = f"{i:06d}.png"
            shutil.move(input_img, os.path.join(set_path, "input", filename))
            shutil.move(label_img, os.path.join(set_path, "label", filename))


def _paired_pngs(data_path: str):
    input_imgs = sorted(glob.glob(os.path.join(data_path, "input", "*.png")))
    label_imgs = sorted(glob.glob(os.path.join(data_path, "label", "*.png")))
    if len(input_imgs) != len(label_imgs):
        raise ValueError("Input and label image count is not the same!")
    imgs = list(zip(input_imgs, label_imgs))
    shuffle(imgs)
    return imgs


def create_right_lane_database(data_path: str, transform=None,
                               use_single_set: bool = False,
                               device=None) -> None:
    """Sim DB: explode videos then 70/15/15 train/valid/test split."""
    if not os.path.exists(data_path):
        raise FileNotFoundError(f"Directory {data_path} does not exist!")
    videos2images(data_path, transform, True, True, device)
    if use_single_set:
        return
    imgs = _paired_pngs(data_path)
    train_end = int(round(len(imgs) * 0.7))
    test_start = int(round(len(imgs) * 0.85))
    if not train_end < test_start:
        raise ValueError("probably too few data is available!")
    _split_move(data_path, [("train", imgs[:train_end]),
                            ("valid", imgs[train_end:test_start]),
                            ("test", imgs[test_start:])])
    shutil.rmtree(os.path.join(data_path, "input"))
    shutil.rmtree(os.path.join(data_path, "label"))


def preprocess_real_db(data_path: str, transform=None,
                       train_ratio: float = 0.7) -> None:
    """Real DB: train/test split + unlabelled re-nest (unlabelled/input)."""
    if not os.path.exists(data_path):
        raise FileNotFoundError(f"Directory {data_path} does not exist!")
    unlabelled_dir = os.path.join(data_path, "unlabelled")
    for d in ("input", "label", "unlabelled"):
        if not os.path.exists(os.path.join(data_path, d)):
            raise FileNotFoundError(f"Directory {d} does not exist!")
    imgs = _paired_pngs(data_path)
    train_end = int(round(len(imgs) * train_ratio))
    _split_move(data_path, [("train", imgs[:train_end]),
                            ("test", imgs[train_end:])])
    tmp = os.path.join(data_path, ".temp")
    shutil.move(unlabelled_dir, tmp)
    shutil.move(tmp, os.path.join(unlabelled_dir, "input"))
    shutil.rmtree(os.path.join(data_path, "input"))
    shutil.rmtree(os.path.join(data_path, "label"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dbType", choices=["sim", "real"], required=True)
    p.add_argument("--single_sim_dir", action="store_true")
    p.add_argument("--dataPath", type=str, default="./realData")
    p.add_argument("--train_ratio", type=float, default=0.7)
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--resize", action="store_true")
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    return p


def main(args=None, device=None) -> None:
    """Build the database; ``device`` (for ``--dbType sim``, whose videos
    are exploded) defaults to ``cuda`` and raises without a card."""
    common.setup_logging()
    args = build_parser().parse_args(args)
    runtime.set_float32_precision()
    seed(42)

    new_res = (args.width, args.height) if args.resize else None
    transform = GrayscaleResizeTransform(args.grayscale, new_res)
    if not 0 < args.train_ratio <= 1:
        raise ValueError(f"--train_ratio {args.train_ratio} is not in (0, 1]")

    if args.dbType == "real":
        preprocess_real_db(args.dataPath, transform, args.train_ratio)
    else:
        create_right_lane_database(args.dataPath, transform,
                                   args.single_sim_dir, device)


if __name__ == "__main__":
    main()
