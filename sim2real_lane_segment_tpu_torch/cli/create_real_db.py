"""Real-database creation CLI, the reference ``utils/createRealDB.py``.

Counterpart of the JAX package's ``cli/create_real_db.py``, with the same
interface: labelme JSON annotations beside raw ``*.png`` frames become
uint8 class masks with the fixed class map {_background_: 0, right: 1,
left: 2, obstacle: 3}; frames with a JSON go to ``input/`` and ``label/``
(``000000.png``, ...), frames without one to ``unlabelled/``; ``--imitate``
runs the whole pipeline and writes nothing.

    python -m sim2real_lane_segment_tpu_torch.cli.create_real_db \\
        --imgPath frames/ --targetPath realData

The JAX CLI paints the shapes with cv2; the card's machine has no cv2, so
``shapes_to_label`` paints them with ``ops/raster`` (cv2's ``fillPoly``,
filled ``rectangle`` and filled ``circle`` at shift 0, as int64 tensor
ops) on the CLI's device, byte for byte as cv2 does.  PNGs are read and
written by ``data/png``.  Runs on the card unless given ``--device cpu``
(or ``main(..., device="cpu")``).
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil

import numpy as np
import torch

from ..core import runtime
from ..data.png import read_png, write_png
from ..ops import raster
from . import common

log = logging.getLogger(__name__)

LABEL_NAME_TO_VALUE = {"_background_": 0, "right": 1, "left": 2, "obstacle": 3}


def shapes_to_label(img_shape, shapes, label_name_to_value,
                    device=None) -> torch.Tensor:
    """A uint8 (H, W) class mask on ``device`` from labelme ``shapes``,
    painted in file order (later shapes over earlier ones); vertices are
    rounded half to even, as the JAX CLI rounds them.  ``device``: the
    card unless the caller asks for the CPU (``runtime.resolve_device``)."""
    device = runtime.resolve_device(device)
    h, w = int(img_shape[0]), int(img_shape[1])
    mask = torch.zeros(h, w, dtype=torch.uint8, device=device)
    for shape in shapes:
        name = shape.get("label")
        if name not in label_name_to_value:
            continue
        pts = np.rint(np.asarray(shape["points"], np.float64)).astype(np.int32)
        shape_type = shape.get("shape_type", "polygon")
        if shape_type == "polygon" and len(pts) >= 3:
            painted = raster.fill_poly(h, w, pts.tolist(), device)
        elif shape_type == "rectangle" and len(pts) == 2:
            painted = raster.fill_rectangle(h, w, pts[0].tolist(),
                                            pts[1].tolist(), device)
        elif shape_type == "circle" and len(pts) == 2:
            r = int(round(np.linalg.norm(pts[1] - pts[0])))
            painted = raster.fill_circle(h, w, pts[0].tolist(), r, device)
        else:
            log.warning("unsupported shape_type %r — skipped", shape_type)
            continue
        mask[painted] = int(label_name_to_value[name])
    return mask


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--imgPath", type=str, required=True,
                   help="Directory of raw frames (*.png) + labelme JSONs")
    p.add_argument("--TargetPath", "--targetPath", dest="targetPath", type=str,
                   default="./realData", help="Output database root")
    p.add_argument("-i", "--imitate", action="store_true",
                   help="Dry run: execute the full pipeline without writes")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(args=None, device=None) -> dict:
    common.setup_logging()
    args = build_parser().parse_args(args)
    device = runtime.resolve_device(device if device is not None
                                    else args.device)

    img_paths = sorted(glob.glob(os.path.join(args.imgPath, "*.png")))
    json_by_stem = {
        os.path.splitext(os.path.basename(jp))[0]: jp
        for jp in glob.glob(os.path.join(args.imgPath, "*.json"))}

    input_dir = os.path.join(args.targetPath, "input")
    label_dir = os.path.join(args.targetPath, "label")
    unlabelled_dir = os.path.join(args.targetPath, "unlabelled")
    if not args.imitate:
        for d in (input_dir, label_dir, unlabelled_dir):
            os.makedirs(d, exist_ok=True)

    n_labelled = n_unlabelled = 0
    for img_path in img_paths:
        stem = os.path.splitext(os.path.basename(img_path))[0]
        jp = json_by_stem.get(stem)
        if jp is None:
            n_unlabelled += 1
            if not args.imitate:
                shutil.copy(img_path, os.path.join(
                    unlabelled_dir, f"{n_unlabelled - 1:06d}.png"))
            continue
        with open(jp) as f:
            data = json.load(f)
        img = read_png(img_path, color=True)
        mask = shapes_to_label(img.shape, data.get("shapes", []),
                               LABEL_NAME_TO_VALUE, device)
        fname = f"{n_labelled:06d}.png"
        n_labelled += 1
        if not args.imitate:
            write_png(os.path.join(input_dir, fname), img)
            write_png(os.path.join(label_dir, fname), mask.cpu().numpy())

    log.info("labelled: %d, unlabelled: %d (imitate=%s)",
             n_labelled, n_unlabelled, args.imitate)
    return {"labelled": n_labelled, "unlabelled": n_unlabelled}


if __name__ == "__main__":
    main()
