"""Writes the comparison montage's header mask for the PyTorch port.

``cli/comparison.py`` (in both packages) heads its montage with a 24-row
BGRA strip on which ``cv2.putText`` writes the six column names in black
(FONT_HERSHEY_SIMPLEX, scale 0.75, at x = 160 i + 20, baseline 21).  The
colour channels stay 0; only the alpha channel takes the text, with
graded edges.  The port runs where cv2 is absent, so it reads that alpha
channel from ``sim2real_lane_segment_tpu_torch/data/assets/
comparison_header.png``, which this script renders with cv2 and writes as
an 8-bit gray PNG.  ``tests/test_torch_video_clis.py`` renders it again
and compares byte for byte.  Run from the repository root:

    python scripts/make_comparison_header.py
"""
import os
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sim2real_lane_segment_tpu_torch.cli.comparison import (  # noqa: E402
    COLS, HEADER_MASK, HEADER_ROWS, TILE_W)


def render_header() -> np.ndarray:
    """The JAX CLI's header strip, (HEADER_ROWS, 6 TILE_W, 4) BGRA."""
    header = np.zeros((HEADER_ROWS, len(COLS) * TILE_W, 4), np.uint8)
    for i, name in enumerate(COLS):
        header = cv2.putText(header, name, (i * TILE_W + 20, 21),
                             cv2.FONT_HERSHEY_SIMPLEX, 0.75, (0, 0, 0, 255))
    return header


def main() -> None:
    header = render_header()
    if header[..., :3].any():
        raise SystemExit("the header's colour channels are not all 0")
    if not cv2.imwrite(HEADER_MASK, header[..., 3]):
        raise SystemExit(f"could not write {HEADER_MASK}")
    print(f"wrote {HEADER_MASK}")


if __name__ == "__main__":
    main()
