"""Side-by-side comparison CLI, the reference ``comparison.py``.

Counterpart of the JAX package's ``cli/comparison.py``, with its
interface (reference comparison.py:64-78): ``random.sample`` draws
``--showCount`` PNGs from ``--dataPath``, and each row of the montage
shows the frame (resized to 160x120 with cv2's LANCZOS4,
``ops.resize.resize_lanczos4_u8``) and beside it the prediction of each
regime's weights (Baseline, S&T, HM, CycleGAN, MME), every pixel of a
class above 0 painted red, under a header naming the columns.  The
montage is a BGRA PNG at ``--resultPath``:

    python -m sim2real_lane_segment_tpu_torch.cli.comparison \\
        --dataPath real/ --baselinePath b.pt --sandtPath s.pt \\
        --hmPath h.pt --cycleganPath c.pt --mmePath m.pt

The reference built 2-class FCDenseNet57 models here (comparison.py:18),
unlike train/test's 4-class 67, a quirk SURVEY.md flags; this CLI keeps
that default and makes it explicit through ``--num_cls``/``--arch``.
The predictions run through the plain module (``predict_step``), as the
JAX CLI's do.  The header is ``cv2.putText``'s, byte for byte: its alpha
channel is a committed mask (``data/assets/comparison_header.png``,
written by ``scripts/make_comparison_header.py``), since the port runs
without cv2.  Runs on the card unless ``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import glob
import os
import random

import numpy as np

from ..core import runtime
from . import common

COLS = ["Input", "Baseline", "S&T", "HM", "CycleGAN", "MME"]
TILE_W, TILE_H = 160, 120
HEADER_ROWS = 24
HEADER_MASK = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "assets", "comparison_header.png")


def header() -> np.ndarray:
    """The montage's (24, 960, 4) BGRA header: the column names in black,
    on a transparent strip."""
    from ..data.png import read_png

    alpha = read_png(HEADER_MASK, color=False)
    out = np.zeros((HEADER_ROWS, len(COLS) * TILE_W, 4), np.uint8)
    out[..., 3] = alpha
    return out


def main(args=None, device=None) -> str:
    common.setup_logging()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--showCount", type=int, default=4)
    p.add_argument("--dataPath", type=str, required=True)
    p.add_argument("--baselinePath", type=str, required=True)
    p.add_argument("--sandtPath", type=str, required=True)
    p.add_argument("--hmPath", type=str, required=True)
    p.add_argument("--cycleganPath", type=str, required=True)
    p.add_argument("--mmePath", type=str, required=True)
    p.add_argument("--resultPath", type=str, default="results/comparison.png")
    p.add_argument("--num_cls", type=int, default=2,
                   help="Reference used 2-class FCDenseNet57 here "
                        "(comparison.py:18)")
    p.add_argument("--arch", choices=["57", "67"], default="57")
    args = p.parse_args(args)
    runtime.set_float32_precision()

    import torch

    from ..data.png import read_png, write_png
    from ..ops.resize import resize_lanczos4_u8
    from .test import load_trainer_and_state

    trainers = [load_trainer_and_state("baseline", wp, num_cls=args.num_cls,
                                       arch=args.arch, height=TILE_H,
                                       width=TILE_W, device=device)
                for wp in (args.baselinePath, args.sandtPath, args.hmPath,
                           args.cycleganPath, args.mmePath)]
    dev = trainers[0].device
    img_paths = random.sample(glob.glob(os.path.join(args.dataPath, "*.png")),
                              args.showCount)

    red = torch.tensor([0, 0, 255], dtype=torch.uint8, device=dev)
    rows = [header()]
    for img_path in img_paths:
        img = torch.from_numpy(read_png(img_path)).to(dev)
        small = resize_lanczos4_u8(img, TILE_H, TILE_W)
        tiles = [small]
        for tr in trainers:
            pred = tr.predict_step(img[None])[0]
            tiles.append(torch.where((pred > 0)[..., None], red, small))
        row = torch.cat(tiles, 1)
        alpha = torch.full_like(row[..., :1], 255)
        rows.append(torch.cat([row, alpha], -1).cpu().numpy())

    os.makedirs(os.path.dirname(args.resultPath) or ".", exist_ok=True)
    write_png(args.resultPath, np.concatenate(rows, axis=0))
    print(f"{args.resultPath} created.")
    return args.resultPath


if __name__ == "__main__":
    main()
