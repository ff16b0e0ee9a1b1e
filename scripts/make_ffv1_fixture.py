"""Writes the FFV1 fixture that the PyTorch port's tests and
``chip_smoke.py`` hold the port's codec against: a recording made by the
JAX package's own CLIs, with cv2's decode of it as SHA-256 digests.

It runs the JAX package's ``cli/datagen.py`` on the CPU (one agent, one
episode of 16 steps at 160x120, in one chunk of 16, so each video has 16
frames and crosses the keyframe that cv2's FFV1 writer puts at frame 12),
then the JAX ``cli/postprocess.py`` on that recording.  Into
``sim2real_lane_segment_tpu_torch/data/assets/ffv1/`` it writes the
recorded pair (``000_orig.avi``, ``000_annot.avi``) and ``digests.json``:
for each video of the pair and for the ``input``/``label`` videos that
postprocess wrote, the SHA-256 of every frame as cv2 decodes it ((H, W, 3)
uint8 BGR, C order).  The card's machine has no cv2, so the digests are
what the port's decoder is held to there.  Run from the repository root
(needs JAX and cv2):

    python scripts/make_ffv1_fixture.py
"""
import hashlib
import json
import os
import random
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import cv2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sim2real_lane_segment_tpu.cli import datagen, postprocess  # noqa: E402

OUT = os.path.join(ROOT, "sim2real_lane_segment_tpu_torch", "data", "assets",
                   "ffv1")
DATAGEN_ARGS = ["--width", "160", "--height", "120", "--episodes", "1",
                "--agents", "1", "--steps", "16", "--chunk", "16"]
PAIR = ("000_orig.avi", "000_annot.avi")


def frame_digests(path: str) -> list[str]:
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(hashlib.sha256(frame.tobytes()).hexdigest())
    cap.release()
    if not out:
        raise SystemExit(f"cv2 decoded no frame of {path}")
    return out


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        rec, post = os.path.join(tmp, "rec"), os.path.join(tmp, "post")
        datagen.main(DATAGEN_ARGS + ["--output_dir", rec])
        random.seed(0)   # postprocess shuffles its recordings
        if postprocess.main(["-id", rec, "-od", post]) != 1:
            raise SystemExit("the JAX postprocess labelled no recording")
        os.makedirs(OUT, exist_ok=True)
        digests = {"datagen_args": DATAGEN_ARGS, "recording": {},
                   "postprocess": {}}
        for name in PAIR:
            shutil.copyfile(os.path.join(rec, name), os.path.join(OUT, name))
            digests["recording"][name] = frame_digests(os.path.join(OUT, name))
        for kind in ("input", "label"):
            digests["postprocess"][kind] = frame_digests(
                os.path.join(post, kind, "000000.avi"))
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in PAIR}
    print(f"wrote {OUT}: {sizes} bytes, "
          f"{len(digests['recording'][PAIR[0]])} frames a video")


if __name__ == "__main__":
    main()
