"""Real-data download CLI, the reference ``utils/getRealData.py``.

Counterpart of the JAX package's ``cli/get_real_data.py``, with the same
interface: downloads the real Duckietown videos listed in a URL file
(``realVideoURLs.txt``; the reference's 78-entry manifest is packaged as
``data/assets/realVideoURLs.txt``) and, with ``--explode``, writes their
frames as PNGs.

    python -m sim2real_lane_segment_tpu_torch.cli.get_real_data --imitate
    python -m sim2real_lane_segment_tpu_torch.cli.get_real_data --explode

``--imitate`` lists what would be downloaded, with no network and no
writes.  Downloads use urllib and fail cleanly per file; videos already in
``--outputPath`` are exploded too.  Frames are read by ``data/videoio``,
which decodes FFV1 and PNG-coded AVI (fourcc ``MPNG``) only: any other
codec (the reference's videos are H.264 MP4s) raises an error that names
it, and nothing is written for that video.  PNGs are written by
``data/png``.
"""
from __future__ import annotations

import argparse
import logging
import os
import urllib.request

from ..data import videoio
from ..data.png import write_png
from . import common

log = logging.getLogger(__name__)

DEFAULT_URL_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                "data", "assets", "realVideoURLs.txt")


def download(url: str, out_dir: str) -> str | None:
    fname = os.path.join(out_dir, url.rstrip("/").split("/")[-1])
    if os.path.exists(fname):
        return fname
    try:
        urllib.request.urlretrieve(url, fname)
        return fname
    except Exception as e:
        log.warning("download failed for %s: %s", url, e)
        return None


def explode(video_path: str, frames_dir: str, counter: int) -> int:
    """Write every frame of ``video_path`` as ``<counter>.png``; returns the
    next counter.  A video coded otherwise than as FFV1 or PNG-in-AVI
    raises ``IOError`` naming its codec before anything is written."""
    codec = videoio.codec_of(video_path)
    if codec not in videoio.CODECS:
        raise IOError(f"{video_path}: frames coded as {codec}; only FFV1 "
                      f"and PNG-coded AVI (fourcc MPNG) are decoded")
    for batch in videoio.read_frames(video_path):
        for frame in batch:
            write_png(os.path.join(frames_dir, f"{counter:06d}.png"), frame)
            counter += 1
    return counter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--urlFile", type=str, default="realVideoURLs.txt")
    p.add_argument("--outputPath", type=str, default="./realVideos")
    p.add_argument("--explode", action="store_true",
                   help="Explode downloaded videos into PNG frames")
    p.add_argument("--framesPath", type=str, default="./realFrames")
    p.add_argument("--imitate", action="store_true",
                   help="Dry-run: list what would be downloaded, no "
                        "network, no writes")
    return p


def main(args=None) -> dict:
    common.setup_logging()
    p = build_parser()
    args = p.parse_args(args)

    urls = []
    url_file = args.urlFile
    if not os.path.exists(url_file):
        if args.urlFile != "realVideoURLs.txt":
            # a manifest named on the command line that does not exist is
            # an error, not a cue to download the packaged 78 videos
            p.error(f"--urlFile {args.urlFile!r} not found")
        url_file = DEFAULT_URL_FILE
    if os.path.exists(url_file):
        with open(url_file) as f:
            urls = [u.strip() for u in f if u.strip()]

    if args.imitate:
        for u in urls[:5]:
            log.info("would download %s", u)
        log.info("imitate: %d urls from %s", len(urls), url_file)
        return {"videos": 0, "frames": 0, "urls": len(urls)}

    os.makedirs(args.outputPath, exist_ok=True)
    videos = []
    for url in urls:
        got = download(url, args.outputPath)
        if got:
            videos.append(got)
    for f in sorted(os.listdir(args.outputPath)):  # videos already on disk
        path = os.path.join(args.outputPath, f)
        if path not in videos and f.lower().endswith((".avi", ".mp4", ".mov")):
            videos.append(path)

    n_frames = 0
    if args.explode:
        os.makedirs(args.framesPath, exist_ok=True)
        for v in videos:
            n_frames = explode(v, args.framesPath, n_frames)

    log.info("videos: %d, frames: %d", len(videos), n_frames)
    return {"videos": len(videos), "frames": n_frames}


if __name__ == "__main__":
    main()
