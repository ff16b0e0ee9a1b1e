"""Video I/O of the port (``data/videoio.py``; FFV1 through ``data/ffv1.py``
over ``csrc/ffv1.cpp``) against cv2 and the JAX package's reader, byte for
byte (both codecs are lossless, so nothing has a tolerance):

- cv2's FFV1 (what the JAX package records) read by the port, colour and
  grey, at 64x48, 61x45 (which cv2 writes as 60x44) and 160x120, 14
  frames a file, so the context states carry over the frames after the
  keyframe at frame 12; the port's own files take 61x45 as it is;
- the port's FFV1 (and PNG-in-AVI) read by cv2 and by
  ``sim2real_lane_segment_tpu.data.videoio.read_frames``; the port codes
  cv2's frames into cv2's own packets and configuration record;
- the encoder's other variants (version 2, range coders with default and
  custom states, context states starting from the record's values, slice
  grids 1x1 to 4x4, no alpha plane, other keyframe intervals) read by cv2
  and by the port, and random frames, sizes and variants under
  hypothesis;
- a flipped byte raises an ``IOError`` naming the frame and slice, and
  streams outside versions 2-3 at 8 bits, RGB or grey, raise by name;
- the committed JAX-written fixture decodes to cv2's digests;
- frame counts, fps, the RIFF size guard and the threaded writer.
"""
import hashlib
import json
import os
import pathlib
import struct

import cv2
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from sim2real_lane_segment_tpu.data import videoio as jvideo
from sim2real_lane_segment_tpu_torch.data import ffv1, videoio

torch.set_num_threads(2)

FIXTURE = (pathlib.Path(__file__).resolve().parents[1]
           / "sim2real_lane_segment_tpu_torch" / "data" / "assets" / "ffv1")
N_FRAMES = 14   # past cv2's keyframe at frame 12


def frames(n, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    f[:, : h // 2, : w // 2] = (10, 200, 30)   # flat regions: run mode
    return f


def smooth_frames(n, h, w, seed=0):
    """Gradients and flat areas, as rendered frames have."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.stack([(xx * (i + 1) + yy * c) // 5 % 256 for i in range(n)
                    for c in (1, 2, 3)], -1).reshape(h, w, n, 3)
    out = np.moveaxis(out, 2, 0).astype(np.uint8)
    out[:, h // 3:, : w // 3] = rng.integers(0, 256, 3, dtype=np.uint8)
    return out


def cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


def cv2_write(path, f, color=True, fps=30.0, fourcc="FFV1"):
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                         (f.shape[2], f.shape[1]), color)
    assert wr.isOpened()
    for x in f:
        wr.write(x)
    wr.release()


def port_frames(path, batch_size=64):
    return np.concatenate(list(videoio.read_frames(path, batch_size)))


def as_bgr(g):
    return np.repeat(g[..., None], 3, axis=-1) if g.ndim == 3 else g


@pytest.mark.parametrize("codec", ["FFV1", "MPNG"])
@pytest.mark.parametrize("h,w,fps", [(48, 64, 30.0), (120, 160, 29.97),
                                     (45, 67, 15.0)])
def test_port_files_read_by_cv2_and_jax(tmp_path, h, w, fps, codec):
    f = frames(N_FRAMES, h, w)
    path = str(tmp_path / "sub" / "a.avi")
    with videoio.VideoWriter(path, (w, h), fps=fps, codec=codec) as wr:
        wr.write(f[0])
        wr.write(f[1:])
    assert videoio.codec_of(path) == codec
    np.testing.assert_array_equal(cv2_frames(path), f)
    np.testing.assert_array_equal(
        np.concatenate(list(jvideo.read_frames(path, 3))), f)
    assert jvideo.frame_count(path) == videoio.frame_count(path) == N_FRAMES
    assert jvideo.fps_of(path) == pytest.approx(fps)
    assert videoio.fps_of(path) == pytest.approx(fps)
    got = list(videoio.read_frames(path, 3))
    assert [len(b) for b in got] == [3, 3, 3, 3, 2]
    np.testing.assert_array_equal(np.concatenate(got), f)


@pytest.mark.parametrize("color", [True, False], ids=["bgr", "gray"])
@pytest.mark.parametrize("w,h", [(64, 48), (61, 45), (160, 120)])
def test_cv2_ffv1_read_by_port(tmp_path, w, h, color):
    f = smooth_frames(N_FRAMES, h, w) if w == 160 else frames(N_FRAMES, h, w)
    path = str(tmp_path / "cv.avi")
    cv2_write(path, f if color else f[..., 1], color)
    ref = cv2_frames(path)
    assert len(ref) == N_FRAMES
    assert videoio.codec_of(path) == "FFV1"
    info = videoio.probe(path)
    d = ffv1.Decoder(info.extradata, info.width, info.height)
    # what cv2 writes: v3.4, Golomb-Rice, RGB with alpha (or grey), 8 bits,
    # a 2x2 grid, CRCs, two quantisation table sets
    assert (d.version, d.micro_version, d.coder, d.colorspace, d.bits,
            d.transparency, d.slices, d.ec, d.quant_tables) == (
        3, 4, 0, int(color), 8, int(color), (2, 2), 1, 2)
    np.testing.assert_array_equal(port_frames(path, 5), ref)
    assert videoio.frame_count(path) == N_FRAMES
    a, b = (np.concatenate(x) for x in zip(*videoio.read_paired_frames(
        path, path, 4)))
    np.testing.assert_array_equal(a, ref)
    np.testing.assert_array_equal(b, ref)


def _chunks(path):
    info = videoio.probe(path)
    return info, list(videoio._frame_chunks(path, info))


def _keyframe_flags(path):
    with open(path, "rb") as f:
        data = f.read()
    i = data.rindex(b"idx1")
    n = struct.unpack("<I", data[i + 4:i + 8])[0]
    return [struct.unpack("<4sIII", data[i + 8 + j:i + 24 + j])[1]
            for j in range(0, n, 16)]


@pytest.mark.parametrize("color", [True, False], ids=["bgr", "gray"])
def test_port_ffv1_is_cv2s_stream(tmp_path, color):
    """cv2's frames coded by the port give cv2's configuration record and
    packets byte for byte, the same keyframes, and a file within 1% of
    cv2's size."""
    f = frames(20, 120, 160, seed=3)
    g = f if color else f[..., 1]
    ours, theirs = str(tmp_path / "port.avi"), str(tmp_path / "cv.avi")
    cv2_write(theirs, g, color)
    with videoio.VideoWriter(ours, (160, 120), is_color=color) as wr:
        wr.write(g)
    (info_a, a), (info_b, b) = _chunks(ours), _chunks(theirs)
    assert info_a.extradata == info_b.extradata
    assert len(a) == len(b) == 20 and all(x == y for x, y in zip(a, b))
    key = [videoio.AVIIF_KEYFRAME if i % 12 == 0 else 0 for i in range(20)]
    assert _keyframe_flags(ours) == _keyframe_flags(theirs) == key
    if color:
        assert abs(os.path.getsize(ours) / os.path.getsize(theirs) - 1) < 0.01
    np.testing.assert_array_equal(cv2_frames(ours), as_bgr(g))


VARIANTS = {
    "v2": dict(version=2),
    "range": dict(coder=1),
    "range_custom_states": dict(coder=2),
    "slices_1x1": dict(slices=(1, 1)),
    "slices_3x2": dict(slices=(3, 2)),
    "slices_4x4": dict(slices=(4, 4)),
    "v2_range_3x2": dict(version=2, coder=1, slices=(3, 2)),
    "v2_custom_4x4": dict(version=2, coder=2, slices=(4, 4)),
    "no_alpha": dict(alpha=False),
    "keyframes_every_5": dict(keyframe_interval=5, coder=1),
    "initial_states": dict(coder=1, initial_states=True),
    "initial_states_custom": dict(coder=2, initial_states=True),
}


@pytest.mark.parametrize("color", [True, False], ids=["bgr", "gray"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ffv1_variants_read_by_cv2_and_port(tmp_path, variant, color):
    f = frames(N_FRAMES, 45, 61, seed=4)
    f[5:] = smooth_frames(N_FRAMES - 5, 45, 61)
    g = f if color else f[..., 1]
    path = str(tmp_path / "v.avi")
    with videoio.VideoWriter(path, (61, 45), is_color=color,
                             ffv1_options=VARIANTS[variant]) as wr:
        wr.write(g)
    np.testing.assert_array_equal(cv2_frames(path), as_bgr(g))
    np.testing.assert_array_equal(port_frames(path), as_bgr(g))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(4, 37), w=st.integers(4, 41), n=st.integers(1, 14),
       color=st.booleans(), coder=st.sampled_from([0, 1, 2]),
       version=st.sampled_from([2, 3]), nh=st.integers(1, 4),
       nv=st.integers(1, 4), flat=st.floats(0, 1), seed=st.integers(0, 999))
# a version-2 Golomb-Rice frame whose first slice's data starts with a byte
# that FFmpeg's end of the range-coded frame header does not decode right
@example(h=4, w=4, n=1, color=False, coder=0, version=2, nh=1, nv=3, flat=0.0,
         seed=1)
def test_random_frames_round_trip(tmp_path, h, w, n, color, coder, version,
                                  nh, nv, flat, seed):
    """Random frames, partly flat (runs) and partly noise, at random sizes,
    slice grids and coders: what the port writes cv2 and the port read
    back unchanged."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    f[rng.random((n, h, w)) < flat] = rng.integers(0, 256, 3, np.uint8)
    g = f if color else f[..., 0]
    path = str(tmp_path / f"r{seed}.avi")
    with videoio.VideoWriter(path, (w, h), is_color=color, ffv1_options=dict(
            version=version, coder=coder, slices=(nh, nv))) as wr:
        wr.write(g)
    np.testing.assert_array_equal(port_frames(path), as_bgr(g))
    np.testing.assert_array_equal(cv2_frames(path), as_bgr(g))


def _flip(path, frame, where=0.5):
    """Flips one byte of frame ``frame``'s chunk, ``where`` of the way in."""
    info, chunks = _chunks(path)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    chunk = chunks[frame]
    pos = data.index(chunk) + int(len(chunk) * where)
    data[pos] ^= 0x5A
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("writer", ["port", "cv2"])
def test_a_corrupted_slice_raises_naming_the_frame(tmp_path, writer):
    f = frames(N_FRAMES, 48, 64, seed=5)
    path = str(tmp_path / "c.avi")
    if writer == "port":
        with videoio.VideoWriter(path, (64, 48)) as wr:
            wr.write(f)
    else:
        cv2_write(path, f)
    _flip(path, 13, 0.6)
    got = []
    with pytest.raises(IOError, match=r"c\.avi: frame 13: slice [0-3]: CRC "
                                      r"mismatch"):
        for batch in videoio.read_frames(path, 1):
            got.append(batch)
    assert len(got) == 13   # no pixels of the corrupted frame
    np.testing.assert_array_equal(np.concatenate(got), f[:13])


def test_a_corrupted_record_raises(tmp_path):
    path = str(tmp_path / "r.avi")
    with videoio.VideoWriter(path, (64, 48)) as wr:
        wr.write(frames(2))
    info = videoio.probe(path)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[data.index(info.extradata) + 10] ^= 1
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(IOError, match="configuration record: CRC mismatch"):
        port_frames(path)


# -- hand-made configuration records (RFC 9043 4.2), for the refusals -------

def _default_states():
    """FFmpeg's default range-coder state tables (one, zero)."""
    one_, factor, max_p = 1 << 32, int(0.05 * (1 << 32)), 248
    one, zero = [0] * 256, [0] * 256
    p, last = one_ // 2, 0
    for _ in range(128):
        p8 = max((256 * p + one_ // 2) >> 32, last + 1)
        if last and p8 <= max_p:
            one[last] = p8
        p += ((one_ - p) * factor + one_ // 2) >> 32
        last = p8
    for i in range(256 - max_p, max_p + 1):
        if not one[i]:
            p = (i * one_ + 128) >> 8
            p += ((one_ - p) * factor + one_ // 2) >> 32
            one[i] = min(max((256 * p + one_ // 2) >> 32, i + 1), max_p)
    for i in range(1, 255):
        zero[i] = 256 - one[256 - i]
    return one, zero


class RecordWriter:
    """The range coder's encoder side, one state array for every field."""
    ONE, ZERO = _default_states()

    def __init__(self):
        self.out, self.low, self.range = bytearray(), 0, 0xFF00
        self.count, self.byte = 0, -1
        self.state = [128] * 32

    def _renorm(self):
        while self.range < 0x100:
            if self.byte < 0:
                self.byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out += bytes([self.byte]) + b"\xff" * self.count
                self.count, self.byte = 0, self.low >> 8
            elif self.low >= 0x10000:
                self.out += bytes([self.byte + 1]) + b"\0" * self.count
                self.count, self.byte = 0, (self.low >> 8) - 0x100
            else:
                self.count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def bit(self, b, state=None, i=0):
        s = self.state if state is None else state
        r1 = self.range * s[i] >> 8
        if b:
            self.low += self.range - r1
            self.range, s[i] = r1, self.ONE[s[i]]
        else:
            self.range -= r1
            s[i] = self.ZERO[s[i]]
        self._renorm()

    def symbol(self, v, state=None):
        s = self.state if state is None else state
        if v == 0:
            return self.bit(1, s, 0)
        e = v.bit_length() - 1
        self.bit(0, s, 0)
        for i in range(e):
            self.bit(1, s, 1 + min(i, 9))
        self.bit(0, s, 1 + min(e, 9))
        for i in range(e - 1, -1, -1):
            self.bit((v >> i) & 1, s, 22 + min(i, 9))

    def finish(self, crc=True):
        self.range, self.low = 0xFF, self.low + 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        out = bytes(self.out)
        return out + _crc32(out).to_bytes(4, "big") if crc else out


def _crc32(data):
    crc = 0
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1)
            crc &= 0xFFFFFFFF
    return crc


QUANT11, QUANT5, ZERO_TABLE = [1, 1, 3, 7, 23, 93], [1, 3, 124], [128]


def record(version=3, colorspace=1, bits=8, chroma=1, transparency=1,
           tables=((QUANT11,) * 3 + (ZERO_TABLE,) * 2,
                   (QUANT11,) * 2 + (QUANT5,) * 3)):
    """A configuration record with these fields (a 2x2 grid, Golomb-Rice,
    ec 1, no initial states); the defaults are cv2's RGB record."""
    r = RecordWriter()
    r.symbol(version)
    if version > 2:
        r.symbol(4)           # micro-version
    for v in (0, colorspace, bits):
        r.symbol(v)
    r.bit(chroma)
    r.symbol(0)
    r.symbol(0)
    r.bit(transparency)
    for v in (1, 1, len(tables)):
        r.symbol(v)
    for table in tables:
        for runs in table:
            state = [128] * 32
            for run in runs:
                r.symbol(run - 1, state)
    for _ in tables:
        r.bit(0)
    if version > 2:
        r.symbol(1)           # ec
        r.symbol(0)           # intra
    return r.finish(crc=version > 2)


def test_hand_made_record_is_cv2s(tmp_path):
    """The record writer above codes cv2's fields into cv2's bytes."""
    path = str(tmp_path / "cv.avi")
    cv2_write(path, frames(1))
    assert videoio.probe(path).extradata == record()


@pytest.mark.parametrize("fields,message", [
    (dict(version=0), "FFV1 version 0 is not supported"),
    (dict(version=1), "FFV1 version 1 is not supported"),
    (dict(version=4), "FFV1 version 4 is not supported"),
    (dict(bits=10), "FFV1 at 10 bits per sample is not supported"),
    (dict(colorspace=0, transparency=0), r"colorspace 0 with chroma planes "
                                         r"\(YCbCr\) is not supported"),
])
def test_unsupported_streams_raise_by_name(fields, message):
    with pytest.raises(IOError, match=message):
        ffv1.Decoder(record(**fields), 64, 48)


def test_a_stream_without_record_is_version_0_or_1(tmp_path):
    """FFV1 versions 0 and 1 carry no configuration record."""
    path = str(tmp_path / "v1.avi")
    with videoio.VideoWriter(path, (64, 48), codec="MPNG") as wr:
        wr.write(frames(1))
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data.replace(b"MPNG", b"FFV1"))
    with pytest.raises(IOError, match=r"v1\.avi: FFV1 version 0 or 1 \(no "
                                      r"configuration record\)"):
        port_frames(path)


def test_fixture_decodes_to_cv2s_digests():
    """The JAX-written recording (``scripts/make_ffv1_fixture.py``) decodes
    to cv2's digests in the port, and cv2 still agrees with them."""
    want = json.loads((FIXTURE / "digests.json").read_text())["recording"]
    for name, digests in want.items():
        path = str(FIXTURE / name)
        assert len(digests) == videoio.frame_count(path) == 16
        for reader in (port_frames, cv2_frames):
            assert [hashlib.sha256(f.tobytes()).hexdigest()
                    for f in reader(path)] == digests, (name, reader)


@pytest.mark.parametrize("codec", ["FFV1", "MPNG"])
def test_gray_stream_reads_as_bgr(tmp_path, codec):
    g = frames(3)[..., 1]
    path = str(tmp_path / "g.avi")
    with videoio.VideoWriter(path, (64, 48), is_color=False,
                             codec=codec) as wr:
        wr.write(g)
    want = np.repeat(g[..., None], 3, axis=-1)
    np.testing.assert_array_equal(cv2_frames(path), want)
    np.testing.assert_array_equal(next(videoio.read_frames(path)), want)


def test_cv2_mpng_files_read_by_port(tmp_path):
    """cv2's MPNG writer (FFmpeg: adaptive row filters, OpenDML headers)."""
    f = frames(5, 40, 56, seed=1)
    path = str(tmp_path / "cv.avi")
    cv2_write(path, f, fps=25.0, fourcc="MPNG")
    np.testing.assert_array_equal(port_frames(path, 2), f)
    assert videoio.frame_count(path) == 5
    assert videoio.fps_of(path) == pytest.approx(25.0)


def test_other_codecs_and_files_are_refused(tmp_path):
    path = str(tmp_path / "x.avi")
    cv2_write(path, frames(2), fourcc="MJPG")
    with pytest.raises(IOError, match="MJPG"):
        next(videoio.read_frames(path))
    with pytest.raises(ValueError, match="MJPG"):
        videoio.VideoWriter(str(tmp_path / "y.avi"), (64, 48), codec="MJPG")
    (tmp_path / "text.avi").write_text("not a video")
    with pytest.raises(IOError, match="not an AVI"):
        videoio.probe(str(tmp_path / "text.avi"))


def test_riff_limit_guard(tmp_path, monkeypatch):
    f = frames(4)
    enc = ffv1.Encoder(64, 48)
    one = max(len(enc.encode(x)[0]) for x in f)
    monkeypatch.setattr(videoio, "RIFF_LIMIT", 2000 + 3 * (one + 40))
    path = str(tmp_path / "big.avi")
    wr = videoio.VideoWriter(path, (64, 48))
    wr.write(f[:2])
    with pytest.raises(ValueError, match="RIFF limit"):
        wr.write(f[2:])
    wr.release()
    # what was written before the refusal stays a valid file
    assert 2 <= videoio.frame_count(path) <= 3
    np.testing.assert_array_equal(cv2_frames(path)[:2], f[:2])
    assert os.path.getsize(path) <= videoio.RIFF_LIMIT


def test_async_writer_order_and_errors(tmp_path):
    f = frames(9)
    path = str(tmp_path / "as.avi")
    with videoio.AsyncVideoWriter(path, (64, 48), maxsize=2) as wr:
        for i in range(0, 9, 2):
            wr.write(f[i:i + 2])
    assert wr.seconds > 0
    np.testing.assert_array_equal(next(videoio.read_frames(path, 64)), f)
    bad = videoio.AsyncVideoWriter(str(tmp_path / "bad.avi"), (64, 48))
    bad.write(frames(1, 10, 10))
    with pytest.raises(ValueError, match="expected"):
        bad.close()
