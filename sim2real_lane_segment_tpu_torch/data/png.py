"""A PNG reader and writer in zlib and numpy, for the dataset trees.

The JAX package reads its PNG trees with cv2, which a machine with only
PyTorch may lack.  This module covers what those trees hold: 8-bit
grayscale (labels) and 8-bit RGB (frames), non-interlaced, with any of
the five row filters.  Like cv2, colour images are BGR in memory:
``read_png`` returns (H, W, 3) BGR or (H, W) gray, and ``write_png``
takes the same.  A gray file read as colour is replicated to three
channels (cv2's ``IMREAD_COLOR``); other formats (palette, alpha, 16-bit,
interlaced, and a colour file read as gray) raise ``ValueError``.

Filters 1 (Sub) and 2 (Up) decode as whole-row numpy operations (an
image whose rows all take one of them, or none, as one operation); 3
(Average) and 4 (Paeth) depend on the decoded byte to their left and
decode byte by byte, which is slower.  ``write_png`` uses Sub unless told
otherwise.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(f: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    if f == 0:
        return line.copy()
    if f == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if f == 2:
        return line + prev  # uint8 arithmetic wraps mod 256
    if f not in (3, 4):
        raise ValueError(f"PNG row filter {f} is not 0-4")
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        if f == 3:
            pred = (a + up[i]) >> 1
        else:
            pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) gray or (H, W, 3) RGB uint8, as stored."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit gray or "
                         "RGB, non-interlaced only)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, stride + 1)
    filters = np.unique(rows[:, 0])
    if len(filters) == 1 and filters[0] in (0, 1, 2):
        # one whole-image operation: Sub sums along rows, Up down columns
        out = rows[:, 1:].copy()
        if filters[0] == 1:
            out = np.cumsum(out.reshape(h, w, bpp), axis=1, dtype=np.uint8)
        elif filters[0] == 2:
            out = np.cumsum(out, axis=0, dtype=np.uint8)
    else:
        out = np.empty((h, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for y in range(h):
            prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:],
                                          prev, bpp)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, 3)


def read_png(path: str, color: bool = True) -> np.ndarray:
    """cv2.imread(path, IMREAD_COLOR / IMREAD_GRAYSCALE) for 8-bit gray or
    RGB PNGs: (H, W, 3) BGR, or (H, W) gray."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if not color:
        if img.ndim != 2:
            raise ValueError(f"{path}: a colour PNG read as gray is not "
                             "supported")
        return img
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])


def _filter_rows(img: np.ndarray, f: int, bpp: int) -> np.ndarray:
    """Rows of ``img`` (H, stride) uint8 under PNG filter ``f``."""
    x = img.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if f == 0:
        pred = np.zeros_like(x)
    elif f == 1:
        pred = left
    elif f == 2:
        pred = up
    elif f == 3:
        pred = (left + up) >> 1
    elif f == 4:
        ul = np.zeros_like(x)
        ul[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    else:
        raise ValueError(f"PNG row filter {f} is not 0-4")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 1,
               level: int = 6) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG bytes, every row under
    ``filter_type``, deflated at zlib ``level``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, bpp = 2, 3
    else:
        raise ValueError(f"cannot write a PNG of shape {img.shape}")
    h, w = img.shape[:2]
    rows = _filter_rows(img.reshape(h, w * bpp), filter_type, bpp)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows],
                         axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 1,
              level: int = 6) -> None:
    """cv2.imwrite for (H, W) gray or (H, W, 3) BGR uint8, deflated at zlib
    ``level``, written atomically (a temporary file, then a rename)."""
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[..., ::-1]
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(encode_png(img, filter_type, level))
    os.replace(tmp, path)
