"""Plumb-bob undistortion on the host, in place of ``cv2.undistort``.

Port of the JAX package's native ``undistort_maps`` and ``remap_u8``
(``super_primitive_tpu/data/native_loader.py``, math in
``csrc/loader.cpp``): the remap tables of ``cv2.initUndistortRectifyMap``
with the new camera matrix equal to K, and a bilinear remap with a
constant-zero border.  OpenCV quantises its bilinear weights to 1/32, so
the remap is not bit-equal to ``cv2.undistort``; it is held to the bounds
the JAX package holds its native remap to.
"""

from __future__ import annotations

import numpy as np


def undistort_maps(K: np.ndarray, dist: np.ndarray, h: int, w: int):
    """(map_x, map_y) float32 (h, w): the distorted source pixel of each
    undistorted pixel, for the 5-term plumb-bob model (k1, k2, p1, p2,
    k3), shorter vectors padded with zeros."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = np.asarray(dist, np.float64).reshape(-1)
    if d.size > 5:
        raise ValueError(f"{d.size} distortion terms: only the 5-term plumb-bob model "
                         "is implemented")
    k1, k2, p1, p2, k3 = np.pad(d, (0, 5 - d.size))
    fx, cx, fy, cy = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    y = ((np.arange(h, dtype=np.float64) - cy) / fy)[:, None]
    x = ((np.arange(w, dtype=np.float64) - cx) / fx)[None, :]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return (xd * fx + cx).astype(np.float32), (yd * fy + cy).astype(np.float32)


def remap_bilinear(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap of a uint8 (h, w) or (h, w, c) image with a
    constant-zero border: taps outside the image count as 0, weights in
    float32, rounded half up."""
    src = np.asarray(src)
    h, w = src.shape[:2]
    img = src.reshape(h, w, -1).astype(np.float32)
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    ax = (map_x - x0).astype(np.float32)[..., None]
    ay = (map_y - y0).astype(np.float32)[..., None]
    acc = np.zeros(map_x.shape + (img.shape[2],), np.float32)
    for dy, dx, wt in ((0, 0, (1 - ax) * (1 - ay)), (0, 1, ax * (1 - ay)),
                       (1, 0, (1 - ax) * ay), (1, 1, ax * ay)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        tap = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        acc += np.where(inside[..., None], wt * tap, np.float32(0))
    out = (acc + np.float32(0.5)).astype(np.uint8)
    return out.reshape(src.shape)
