"""FFV1 frames through ``csrc/ffv1.cpp``, the port's own codec (RFC 9043,
versions 2 and 3 at 8 bits), bound with ctypes.

FFV1 is what the JAX package and the reference record (cv2's
``VideoWriter_fourcc("FFV1")``: version 3, Golomb-Rice coding, RGB with
an alpha plane, a 2x2 slice grid, a keyframe every 12 frames).  The codec
is host code, built at first use by ``kernels/build.py`` with the host's
C++ compiler.  ctypes releases the interpreter lock during each call, so
several writers encode at once, and a frame's slices run on threads of
their own.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build

# cv2's (FFmpeg's) choices for an FFV1 stream, which the writers keep
VERSION = 3
CODER = 0            # 0 Golomb-Rice, 1 range coder, 2 range with own states
SLICES = (2, 2)      # (horizontal, vertical)
KEYFRAME_INTERVAL = 12


def _load() -> ctypes.CDLL:
    """The codec's library (built and cached by ``kernels.build``), its
    functions' types declared."""
    lib = build.load("ffv1")
    vp, c, i, lg = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, \
        ctypes.c_long
    lib.ffv1_last_error.restype = c
    lib.ffv1_decoder_new.restype = vp
    lib.ffv1_decoder_new.argtypes = [c, lg, i, i]
    lib.ffv1_decoder_info.argtypes = [vp, vp]
    lib.ffv1_decode.argtypes = [vp, c, lg, vp]
    lib.ffv1_decoder_free.argtypes = [vp]
    lib.ffv1_encoder_new.restype = vp
    lib.ffv1_encoder_new.argtypes = [i] * 10
    lib.ffv1_encoder_extradata.restype = lg
    lib.ffv1_encoder_extradata.argtypes = [vp, vp, lg]
    lib.ffv1_encode.restype = lg
    lib.ffv1_encode.argtypes = [vp, vp, ctypes.POINTER(i)]
    lib.ffv1_encoder_packet.argtypes = [vp, vp]
    lib.ffv1_encoder_free.argtypes = [vp]
    return lib


def _error(lib) -> str:
    return lib.ffv1_last_error().decode(errors="replace")


class Decoder:
    """Decodes the frames of one FFV1 stream, in order: a frame's context
    states carry over from the one before it, back to a keyframe.
    ``extradata`` is the stream's configuration record (the AVI ``strf``
    bytes after its BITMAPINFOHEADER)."""

    def __init__(self, extradata: bytes, width: int, height: int):
        self._lib = _load()
        self.width, self.height = width, height
        self._h = self._lib.ffv1_decoder_new(bytes(extradata), len(extradata),
                                             width, height)
        if not self._h:
            raise IOError(_error(self._lib))
        info = (ctypes.c_int * 10)()
        self._lib.ffv1_decoder_info(self._h, info)
        (self.version, self.micro_version, self.coder, self.colorspace,
         self.bits, self.transparency, nh, nv, self.ec,
         self.quant_tables) = list(info)
        self.slices = (nh, nv)

    def decode(self, chunk: bytes) -> np.ndarray:
        """One frame as (H, W, 3) uint8 BGR (grey repeated into all three).
        Raises IOError, naming the frame and slice, on a CRC mismatch or
        any other fault; no pixels come back then."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        if self._lib.ffv1_decode(self._h, bytes(chunk), len(chunk),
                                 out.ctypes.data) < 0:
            raise IOError(_error(self._lib))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ffv1_decoder_free(self._h)
            self._h = None


class Encoder:
    """Codes (H, W, 3) BGR (or (H, W) grey with ``is_color=False``) uint8
    frames as FFV1.  The defaults are cv2's; the other versions, coders,
    slice grids, keyframe intervals, streams without alpha and range-coder
    states that start from the configuration record's own values
    (``initial_states``) exist so that every branch of the decoder can be
    held against cv2's."""

    def __init__(self, width: int, height: int, is_color: bool = True,
                 version: int = VERSION, coder: int = CODER,
                 slices: tuple[int, int] = SLICES,
                 keyframe_interval: int = KEYFRAME_INTERVAL,
                 alpha: bool = True, initial_states: bool = False):
        self._lib = _load()
        self.width, self.height, self.is_color = width, height, is_color
        self._h = self._lib.ffv1_encoder_new(
            width, height, int(is_color), version, coder, slices[0],
            slices[1], keyframe_interval, int(alpha), int(initial_states))
        if not self._h:
            raise ValueError(_error(self._lib))
        n = self._lib.ffv1_encoder_extradata(self._h, None, 0)
        buf = ctypes.create_string_buffer(n)
        self._lib.ffv1_encoder_extradata(self._h, buf, n)
        self.extradata = buf.raw

    def encode(self, frame: np.ndarray) -> tuple[bytes, bool]:
        """The packet of one frame, and whether it is a keyframe."""
        want = (self.height, self.width) + ((3,) if self.is_color else ())
        frame = np.ascontiguousarray(frame)
        if frame.shape != want or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype}, expected "
                             f"{want} uint8")
        key = ctypes.c_int()
        n = self._lib.ffv1_encode(self._h, frame.ctypes.data,
                                  ctypes.byref(key))
        if n < 0:
            raise ValueError(_error(self._lib))
        buf = ctypes.create_string_buffer(n)
        self._lib.ffv1_encoder_packet(self._h, buf)
        return buf.raw, bool(key.value)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ffv1_encoder_free(self._h)
            self._h = None
