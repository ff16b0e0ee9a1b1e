"""The port's cv2-free image ops (``ops/resize.py``) against cv2: the
uint8 INTER_LINEAR, INTER_AREA and INTER_NEAREST resizes and
COLOR_BGR2GRAY bit for bit, and the float32 INTER_CUBIC of the photo
pack's noise bit for bit with OpenCV's own kernels (IPP off) and within
IPP_CUBIC_ATOL of the calls a cv2 with IPP hands to IPP."""
import cv2
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu_torch.ops import resize

# float32 cubic through IPP: sums in another order, ~10 ulp of values of
# magnitude ~4 (measured worst 4.9e-6)
IPP_CUBIC_ATOL = 1e-5


@pytest.fixture(params=[False, True], ids=["ipp_off", "ipp_on"])
def ipp(request):
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(request.param)
    yield request.param
    cv2.ipp.setUseIPP(before)


def u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


SHAPES = [(480, 640, 120, 160), (48, 64, 24, 32), (48, 64, 30, 40),
          (37, 41, 29, 23), (50, 70, 120, 160), (13, 17, 100, 3)]


@pytest.mark.parametrize("h,w,oh,ow", SHAPES)
@pytest.mark.parametrize("channels", [1, 3])
def test_linear_and_nearest_u8(ipp, h, w, oh, ow, channels):
    x = u8((h, w, 3) if channels == 3 else (h, w), seed=h + w)
    got = resize.resize_linear_u8(torch.from_numpy(x), oh, ow).numpy()
    np.testing.assert_array_equal(got, cv2.resize(x, (ow, oh)))
    got = resize.resize_nearest_u8(torch.from_numpy(x), oh, ow).numpy()
    np.testing.assert_array_equal(got, cv2.resize(
        x, (ow, oh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("h,w,oh,ow", [
    (512, 512, 256, 256), (768, 768, 256, 256), (1024, 768, 256, 256),
    (300, 500, 256, 256), (129, 130, 64, 64), (64, 64, 256, 256),
    (100, 300, 256, 256), (256, 256, 256, 256), (7, 5, 3, 2)])
def test_area_u8(ipp, h, w, oh, ow):
    x = u8((h, w, 3), seed=h * w)
    got = resize.resize_area_u8(torch.from_numpy(x), oh, ow).numpy()
    np.testing.assert_array_equal(got, cv2.resize(
        x, (ow, oh), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("n,oh,ow", [(16, 256, 256), (128, 256, 256),
                                     (50, 256, 256), (20, 40, 250),
                                     (30, 40, 253)])
def test_cubic_f32(ipp, n, oh, ow):
    x = np.random.default_rng(n).standard_normal((n, n + 3)).astype(
        np.float32)
    got = resize.resize_cubic_f32(torch.from_numpy(x), oh, ow).numpy()
    ref = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_CUBIC)
    if ipp:
        np.testing.assert_allclose(got, ref, rtol=0, atol=IPP_CUBIC_ATOL)
    else:
        np.testing.assert_array_equal(got, ref)


def test_bgr_to_gray_every_colour():
    v = np.arange(1 << 24, dtype=np.int64)
    x = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                 -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(
        resize.bgr_to_gray_u8(torch.from_numpy(x)).numpy(),
        cv2.cvtColor(x, cv2.COLOR_BGR2GRAY))
