"""Fisheye camera distortion: the reference's Distortion model, numpy only.

Counterpart of the JAX package's ``sim/distortion.py``.  The reference
(gym_duckietown/distortion.py) used the published RasPi camera
calibration (plumb-bob k1, k2, t1, t2, k3) to distort rendered frames
through cv2 remap tables inverted pixel by pixel (distortion.py:80-156).
Here the pixel -> ray grid is distorted once at build time
(``render.make_ray_grid``): each output pixel's ray is bent by the
inverted distortion, so frames come out distorted at no per-frame cost.
``undistort_maps`` gives the classic image-space remap tables.
"""
from __future__ import annotations

import numpy as np

# published RasPi calibration used by the reference (distortion.py:10-36)
CAMERA_MATRIX = np.array([
    [305.5718893575089, 0.0, 303.0797142544728],
    [0.0, 308.8338858195428, 231.8845403702499],
    [0.0, 0.0, 1.0],
])
DIST_COEFS = np.array([-0.2, 0.0305,
                       0.0005859930422629722, -0.0006697840226199427, 0.0])
PROJECTION_MATRIX = np.array([
    [220.2460277141687, 0.0, 301.8668918355899],
    [0.0, 238.6758484095299, 227.0880056118307],
    [0.0, 0.0, 1.0],
])
CALIB_W, CALIB_H = 640, 480


def distort_normalized(x: np.ndarray, y: np.ndarray,
                       coefs: np.ndarray = DIST_COEFS):
    """Forward plumb-bob distortion of normalized camera coords."""
    k1, k2, t1, t2, k3 = coefs
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * t1 * x * y + t2 * (r2 + 2 * x * x)
    yd = y * radial + t1 * (r2 + 2 * y * y) + 2 * t2 * x * y
    return xd, yd


def invert_distort(xd: np.ndarray, yd: np.ndarray, iters: int = 50):
    """Invert the plumb-bob model by fixed-point iteration (contraction
    factor ~|3*k1*r^2|, so wide-angle points need many cheap iterations)."""
    x, y = np.array(xd, dtype=np.float64), np.array(yd, dtype=np.float64)
    for _ in range(iters):
        fx_, fy_ = distort_normalized(x, y)
        x = x - (fx_ - xd)
        y = y - (fy_ - yd)
    return x, y


def distorted_ray_grid(height: int, width: int) -> np.ndarray:
    """(H, W, 3) camera-frame ray directions producing a distorted render.

    Output pixel (u, v) maps through the projection matrix to normalized
    rectified coords; the *inverse* distortion bends the ray so that the
    rendered image matches what the distorted physical camera would see.
    We invert the forward model with a few fixed-point iterations
    (smooth, converges fast for these coefficients).
    """
    scale_x = width / CALIB_W
    scale_y = height / CALIB_H
    fx, fy = CAMERA_MATRIX[0, 0] * scale_x, CAMERA_MATRIX[1, 1] * scale_y
    cx, cy = CAMERA_MATRIX[0, 2] * scale_x, CAMERA_MATRIX[1, 2] * scale_y

    u, v = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    xd = (u - cx) / fx
    yd = (v - cy) / fy

    x, y = invert_distort(xd, yd)

    dirs = np.stack([x, -y, np.ones_like(x)], axis=-1)
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


def undistort_maps(height: int, width: int):
    """(mapx, mapy) float32 for cv2.remap-style undistortion of camera
    images (the UndistortWrapper / real-robot path)."""
    scale_x = width / CALIB_W
    scale_y = height / CALIB_H
    fx, fy = CAMERA_MATRIX[0, 0] * scale_x, CAMERA_MATRIX[1, 1] * scale_y
    cx, cy = CAMERA_MATRIX[0, 2] * scale_x, CAMERA_MATRIX[1, 2] * scale_y
    pfx, pfy = PROJECTION_MATRIX[0, 0] * scale_x, PROJECTION_MATRIX[1, 1] * scale_y
    pcx, pcy = PROJECTION_MATRIX[0, 2] * scale_x, PROJECTION_MATRIX[1, 2] * scale_y

    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    # rectified pixel -> normalized -> forward distort -> raw pixel
    x = (u - pcx) / pfx
    y = (v - pcy) / pfy
    xd, yd = distort_normalized(x, y)
    mapx = (xd * fx + cx).astype(np.float32)
    mapy = (yd * fy + cy).astype(np.float32)
    return mapx, mapy
