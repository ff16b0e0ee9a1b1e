"""cv2-free bicubic and LANCZOS4 resampling (``ops.resize.resize_cubic_u8``,
``resize_lanczos4_u8``) against cv2.resize on seeded uint8 frames.

The port repeats OpenCV's own fixed-point kernels, so the target is
bit-equality.  cv2's pip build hands some INTER_CUBIC calls to Intel IPP,
whose rounding differs; with IPP off (OpenCV's own code) every case must be
bit-equal, and with IPP on (cv2's default, what the JAX CLIs run) the cubic
cases may differ by at most 1 level on at most ``IPP_CUBIC_SHARE`` of the
values.  LANCZOS4 must be bit-equal either way.
"""
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu_torch.ops.resize import (resize_cubic_u8,
                                                        resize_lanczos4_u8)

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)

# (source (H, W), destination (h, w)): the CycleGAN CLIs' down and up
# resizes, two odd sizes (non-integer scales both ways), and a frame
# already at the model's size, which cv2 copies (the calibration and
# montage CLIs resize every frame)
SIZES = [((480, 640), (120, 160)), ((120, 160), (480, 640)),
         ((37, 53), (61, 29)), ((100, 90), (33, 47)),
         ((120, 160), (120, 160))]
IPP_CUBIC_SHARE = 0.07
KINDS = {"cubic": (resize_cubic_u8, "INTER_CUBIC"),
         "lanczos4": (resize_lanczos4_u8, "INTER_LANCZOS4")}


def _frames(seed, size, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, *size, 3),
                                                dtype=np.uint8)


def _cv2(frames, size, flag, ipp):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        return np.stack([cv2.resize(f, size[::-1],
                                    interpolation=getattr(cv2, flag))
                         for f in frames])
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("src,dst", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_bit_equal_to_opencv_kernel(kind, src, dst):
    fn, flag = KINDS[kind]
    frames = _frames(sum(src) + sum(dst), src)
    want = _cv2(frames, dst, flag, ipp=False)
    got = fn(torch.from_numpy(frames), *dst).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("src,dst", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_against_default_cv2(kind, src, dst):
    fn, flag = KINDS[kind]
    frames = _frames(sum(src) * 3 + sum(dst), src)
    want = _cv2(frames, dst, flag, ipp=True)
    got = fn(torch.from_numpy(frames), *dst).numpy()
    diff = np.abs(got.astype(int) - want)
    if kind == "lanczos4":
        assert diff.max() == 0, f"{int((diff > 0).sum())} values differ"
    else:
        assert diff.max() <= 1
        assert (diff > 0).mean() <= IPP_CUBIC_SHARE


def test_leading_dims_and_single_frame():
    frames = _frames(5, (30, 40), n=6).reshape(2, 3, 30, 40, 3)
    got = resize_cubic_u8(torch.from_numpy(frames), 12, 16)
    assert got.shape == (2, 3, 12, 16, 3)
    one = resize_cubic_u8(torch.from_numpy(frames[1, 2]), 12, 16)
    np.testing.assert_array_equal(one.numpy(), got[1, 2].numpy())


def test_rejects_float_frames():
    with pytest.raises(TypeError):
        resize_lanczos4_u8(torch.zeros(4, 4, 3), 8, 8)
