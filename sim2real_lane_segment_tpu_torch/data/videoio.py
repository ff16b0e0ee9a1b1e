"""Video I/O: lossless AVI files whose frames are PNGs, read in batches.

Counterpart of the JAX package's ``data/videoio.py``, which records the
reference's format (rightLaneDatagen/gym_duckietown/recorder.py:24: FFV1
lossless AVI, 640x480 at 30 fps) through cv2.  A machine with only
PyTorch has no cv2 and no FFV1 codec, so the port writes another lossless
AVI: a RIFF ``AVI `` file with one video stream of fourcc ``MPNG``, one
``00dc`` chunk per frame holding a whole PNG (``data/png.encode_png``,
Sub filter, zlib level ``ZLIB_LEVEL``) and an ``idx1`` index.  cv2 (and so
the JAX package's reader) reads these files frame for frame, and this
module reads the ``MPNG`` AVIs cv2 writes (OpenDML ones included).  It
does not decode FFV1.

Frames are BGR in memory, as cv2 hands them out; the PNGs hold RGB.  A
file stays under the RIFF limit of 1 GiB (about 2,000 frames at 480x640):
the writer raises before a frame would cross it and writes no OpenDML
extension.  Reading is batched into (N, H, W, 3) uint8 blocks.
"""
from __future__ import annotations

import contextlib
import os
import queue
import struct
import threading
import time
from fractions import Fraction
from typing import Iterator, NamedTuple

import numpy as np

from .png import decode_png, encode_png

# zlib level of the frames' PNGs: every level is lossless; 1 deflates a
# 480x640 frame in about a sixth of level 6's time, into ~5% more bytes
ZLIB_LEVEL = 1
RIFF_LIMIT = 1 << 30
AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
PNG_FOURCC = b"MPNG"


class AviInfo(NamedTuple):
    width: int
    height: int
    fps: float
    n_frames: int
    fourcc: bytes
    movi: list   # (start, end) byte ranges of the movi lists' contents


def _fps_fraction(fps: float) -> tuple[int, int]:
    f = Fraction(fps).limit_denominator(1001)
    return f.denominator, f.numerator   # (dwScale, dwRate)


class VideoWriter:
    """PNG-in-AVI writer; accepts single frames or (N, H, W, 3) batches of
    BGR uint8 ((N, H, W) gray with ``is_color=False``)."""

    def __init__(self, path: str, frame_size: tuple[int, int] = (640, 480),
                 fps: float = 30.0, is_color: bool = True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.width, self.height = frame_size
        self.is_color = is_color
        self._scale, self._rate = _fps_fraction(fps)
        self._index: list[tuple[int, int]] = []
        self._largest = 0
        self.seconds = 0.0   # spent in write(): encoding and file writes
        self._f = open(path, "wb")
        self._f.write(self._headers(final=False))
        self._movi = self._f.tell() - 4   # the 'movi' fourcc

    def _headers(self, final: bool) -> bytes:
        """RIFF, hdrl and movi headers; ``final`` counts the idx1 index."""
        w, h, n = self.width, self.height, len(self._index)
        bits = 24 if self.is_color else 8
        us = round(1e6 * self._scale / self._rate)
        avih = struct.pack("<14I", us, 0, 0, AVIF_HASINDEX, n, 0, 1,
                           self._largest, w, h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"MPNG", 0, 0, 0,
                           0, self._scale, self._rate, 0, n, self._largest,
                           -1, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, bits, b"MPNG",
                           w * h * bits // 8, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        movi_size = 4 + sum(8 + s + (s & 1) for _, s in self._index)
        total = 4 + 8 + len(hdrl) + 8 + movi_size + (8 + 16 * n if final
                                                     else 0)
        return (b"RIFF" + struct.pack("<I", total) + b"AVI "
                + _chunk(b"LIST", hdrl)
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, frames: np.ndarray) -> None:
        frames = np.asarray(frames)
        if frames.ndim == (3 if self.is_color else 2):
            frames = frames[None]
        want = (self.height, self.width) + ((3,) if self.is_color else ())
        t0 = time.perf_counter()
        for f in frames:
            if f.shape != want or f.dtype != np.uint8:
                raise ValueError(f"{self.path}: frame {f.shape} {f.dtype}, "
                                 f"expected {want} uint8")
            data = encode_png(f[..., ::-1] if self.is_color else f,
                              level=ZLIB_LEVEL)
            pos = self._f.tell()
            n = len(self._index) + 1
            if pos + 8 + len(data) + 1 + 8 + 16 * n > RIFF_LIMIT:
                raise ValueError(
                    f"{self.path}: frame {n} would take the file past the "
                    f"RIFF limit of {RIFF_LIMIT} bytes; write fewer frames "
                    f"per file")
            self._f.write(b"00dc" + struct.pack("<I", len(data)) + data
                          + (b"\0" if len(data) & 1 else b""))
            self._index.append((pos - self._movi, len(data)))
            self._largest = max(self._largest, len(data))
        self.seconds += time.perf_counter() - t0

    def release(self) -> None:
        if self._f.closed:
            return
        try:
            idx = b"".join(struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME,
                                       off, size)
                           for off, size in self._index)
            self._f.write(_chunk(b"idx1", idx))
            self._f.seek(0)
            self._f.write(self._headers(final=True))
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return (fourcc + struct.pack("<I", len(body)) + body
            + (b"\0" if len(body) & 1 else b""))


def _walk(f, start: int, end: int):
    """(fourcc, body offset, size) of the chunks in [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(8)
        if len(head) < 8:
            return
        fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


def probe(path: str) -> AviInfo:
    """The stream header of an AVI file: size, fps, frame count (the
    stream's ``dwLength``, or OpenDML's ``dmlh`` total where present) and
    the byte ranges of its ``movi`` lists."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:] != b"AVI ":
            raise IOError(f"could not open video {path}: not an AVI file")
        f.seek(0, os.SEEK_END)
        file_end = f.tell()
        info = dict(movi=[])
        for riff, off, size in _walk(f, 0, file_end):
            if riff != b"RIFF":
                continue
            for fourcc, boff, bsize in _walk(f, off + 4, off + size):
                if fourcc != b"LIST":
                    continue
                f.seek(boff)
                kind = f.read(4)
                if kind == b"movi":
                    info["movi"].append((boff + 4, boff + bsize))
                elif kind == b"hdrl":
                    _read_hdrl(f, boff + 4, boff + bsize, info)
        if "fps" not in info:
            raise IOError(f"could not open video {path}: no video stream")
        return AviInfo(info["width"], info["height"], info["fps"],
                       info.get("dmlh", info["length"]), info["fourcc"],
                       info["movi"])


def _read_hdrl(f, start: int, end: int, info: dict) -> None:
    for fourcc, off, size in _walk(f, start, end):
        f.seek(off)
        if fourcc == b"LIST":
            kind = f.read(4)
            if kind in (b"strl", b"odml") and "fps" not in info:
                _read_hdrl(f, off + 4, off + size, info)
        elif fourcc == b"strh":
            body = f.read(size)
            if body[:4] == b"vids" and "fps" not in info:
                scale, rate = struct.unpack("<II", body[20:28])
                info["fps"] = rate / scale if scale else 30.0
                info["length"] = struct.unpack("<I", body[32:36])[0]
                info["handler"] = body[4:8]
        elif fourcc == b"strf" and "fourcc" not in info and "fps" in info:
            body = f.read(size)
            w, h = struct.unpack("<ii", body[4:12])
            info["width"], info["height"] = w, abs(h)
            info["fourcc"] = body[16:20]
        elif fourcc == b"dmlh":
            info["dmlh"] = struct.unpack("<I", f.read(4))[0]


def _frame_chunks(path: str, info: AviInfo) -> Iterator[bytes]:
    """The bytes of each frame of stream 0, in file order."""
    with open(path, "rb") as f:
        for start, end in info.movi:
            for fourcc, off, size in _walk(f, start, end):
                if fourcc in (b"00dc", b"00db") and size:
                    f.seek(off)
                    yield f.read(size)


def _decode(data: bytes, path: str) -> np.ndarray:
    try:
        img = decode_png(data)
    except ValueError as e:
        raise IOError(f"{path}: a frame is not a PNG ({e}); only PNG-coded "
                      f"AVI (fourcc MPNG) is read, not FFV1") from e
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])


def read_frames(path: str, batch_size: int = 64) -> Iterator[np.ndarray]:
    """Yield (N, H, W, 3) uint8 BGR batches from a video file."""
    info = probe(path)
    if info.fourcc != PNG_FOURCC:
        raise IOError(f"{path}: frames coded as {info.fourcc!r}; only "
                      f"PNG-coded AVI (fourcc MPNG) is read, not FFV1")
    buf = []
    for data in _frame_chunks(path, info):
        buf.append(_decode(data, path))
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def read_paired_frames(path_a: str, path_b: str, batch_size: int = 64
                       ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield paired batches from two equal-length videos (orig/annot)."""
    for a, b in zip(read_frames(path_a, batch_size),
                    read_frames(path_b, batch_size)):
        n = min(len(a), len(b))
        yield a[:n], b[:n]


# an MP4/QuickTime sample entry's fourcc -> the codec's name
_MP4_CODECS = {b"avc1": "H.264", b"avc3": "H.264", b"hvc1": "H.265",
               b"hev1": "H.265", b"mp4v": "MPEG-4 Part 2", b"av01": "AV1",
               b"vp09": "VP9", b"mjpa": "Motion JPEG", b"jpeg": "Motion JPEG"}


def _mp4_boxes(f, end: int):
    """(type, payload start, payload end) of the boxes from the file's
    position to ``end``."""
    pos = f.tell()
    while pos + 8 <= end:
        f.seek(pos)
        size, kind = struct.unpack(">I4s", f.read(8))
        head = 8
        if size == 1:
            size = struct.unpack(">Q", f.read(8))[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            return
        yield kind, pos + head, pos + size
        pos += size


def codec_of(path: str) -> str:
    """The codec of a video file's frames, named: an AVI's fourcc
    (``MPNG`` is the one ``read_frames`` reads), or for an MP4/QuickTime
    file the codec of its video sample entry (``H.264 (avc1)``, ...)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] == b"RIFF" and head[8:] == b"AVI ":
            return probe(path).fourcc.decode("latin-1")
        if head[4:8] not in (b"ftyp", b"moov", b"mdat", b"free", b"wide"):
            return f"unknown (not an AVI or MP4 file: {head[:8]!r})"
        f.seek(0, os.SEEK_END)
        end = f.tell()
        f.seek(0)
        for kind, start, stop in _mp4_boxes(f, end):
            if kind != b"moov":
                continue
            f.seek(start)
            moov = f.read(stop - start)
            i = moov.find(b"stsd")
            while i >= 0:
                # version and flags, entry count, entry size, entry type
                entry = moov[i + 16:i + 20]
                if entry in _MP4_CODECS:
                    return f"{_MP4_CODECS[entry]} ({entry.decode()})"
                i = moov.find(b"stsd", i + 4)
            return "unknown (no video sample entry in the MP4 file)"
    return "unknown (an MP4 file without a moov box)"


def frame_count(path: str) -> int:
    return probe(path).n_frames


def fps_of(path: str) -> float:
    return probe(path).fps or 30.0


class AsyncVideoWriter:
    """Threaded writer: enqueue batches, encode on a background thread.

    The reference's Recorder used the same queue+thread shape
    (recorder.py:21-63).  zlib releases the interpreter lock while it
    deflates, so several writers (a recording's orig and annot streams)
    encode in parallel with each other and with the device.
    """

    def __init__(self, path: str, frame_size=(640, 480), fps=30.0,
                 is_color=True, maxsize: int = 8):
        self._writer = VideoWriter(path, frame_size, fps, is_color)
        self.path = path
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            if self._err is not None:
                continue  # drain, so that write() and close() never block
            try:
                self._writer.write(item)
            except Exception as e:  # surfaced on write() and close()
                self._err = e

    @property
    def seconds(self) -> float:
        """Seconds the background thread spent encoding and writing."""
        return self._writer.seconds

    def write(self, frames) -> None:
        if self._err:
            raise self._err
        self._q.put(np.asarray(frames))

    def close(self) -> None:
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()
        self._writer.release()
        if self._err:
            raise self._err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            with contextlib.suppress(Exception):
                self.close()
