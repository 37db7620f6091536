"""Image resizes with OpenCV's semantics (``cv2.INTER_NEAREST`` and
``cv2.INTER_LINEAR``), in numpy.

Frozen copy of ``super_primitive_tpu_torch/image/resize.py``
(``nn_resize``, ``linear_resize``) at commit 51882e36a88e.  It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np

def _nearest_index(dst: int, src: int) -> np.ndarray:
    """cv2.INTER_NEAREST source index of each destination index:
    floor(i * (1 / (dst / src))) in double, clipped to the last pixel."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def nn_resize(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize with cv2.INTER_NEAREST semantics on (H, W),
    (H, W, C<=4) or leading-batch (N, H, W) arrays."""
    H, W = hw
    batch = not (x.ndim == 2 or (x.ndim == 3 and x.shape[-1] <= 4))
    src_hw = x.shape[-2:] if batch else x.shape[:2]
    if tuple(src_hw) == (H, W):
        return x
    ri = _nearest_index(H, src_hw[0])
    ci = _nearest_index(W, src_hw[1])
    if batch:
        # two takes keep the (N, H, W) stack C-ordered; one advanced index
        # x[:, ri, ci] would lay it out with N fastest
        return np.take(np.take(x, ri, axis=1), ci, axis=2)
    return x[ri[:, None], ci[None, :]]


def _linear_taps(dst: int, src: int, clamp_weight: bool):
    """Half-pixel-centre source taps and the weight of the second tap, as
    cv2.resize computes them: the column weights are zeroed at the borders,
    the row weights are not (their taps are clipped instead)."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    if clamp_weight:
        f = np.where(s < 0, 0.0, f)
        s = np.where(s < 0, 0, s)
        edge = s >= src - 1
        f = np.where(edge, 0.0, f)
        s = np.where(edge, src - 1, s)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f.astype(np.float32)


def linear_resize(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) uint8 or float32 image with
    cv2.INTER_LINEAR semantics.

    An exact 2x reduction is a 2x2 mean, as OpenCV takes it; uint8 rounds it
    half up.  Other ratios use OpenCV's separable taps: uint8 with its 11-bit
    fixed-point weights and its vectorised rounding, float32 in float32."""
    H, W = hw
    Hs, Ws = x.shape[:2]
    if (Hs, Ws) == (H, W):
        return x.copy()
    if Hs == 2 * H and Ws == 2 * W:
        a, b = x[0::2, 0::2], x[0::2, 1::2]
        c, d = x[1::2, 0::2], x[1::2, 1::2]
        if x.dtype == np.uint8:
            s = a.astype(np.int32) + b + c + d
            return ((s + 2) >> 2).astype(np.uint8)
        return ((a + b) + (c + d)) * np.float32(0.25)
    sy, sy1, fy = _linear_taps(H, Hs, clamp_weight=False)
    sx, sx1, fx = _linear_taps(W, Ws, clamp_weight=True)
    if x.dtype == np.uint8:
        one = 2048  # 1 << INTER_RESIZE_COEF_BITS
        ax0 = np.round((1.0 - fx) * one).astype(np.int64)[None, :, None]
        ay0 = np.round((1.0 - fy) * one).astype(np.int64)[:, None, None]
        xi = x.astype(np.int64)
        hor = xi[:, sx] * ax0 + xi[:, sx1] * (one - ax0)
        out = (
            (((hor[sy] >> 4) * ay0) >> 16) + (((hor[sy1] >> 4) * (one - ay0)) >> 16) + 2
        ) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    wx = fx[None, :, None]
    wy = fy[:, None, None]
    hor = x[:, sx] * (1.0 - wx) + x[:, sx1] * wx
    return (hor[sy] * (1.0 - wy) + hor[sy1] * wy).astype(np.float32)
