"""Image resizes with OpenCV's and with ``jax.image.resize``'s semantics.

numpy replacements of the ``cv2.resize`` calls the JAX package makes
(``cv2.INTER_NEAREST`` and ``cv2.INTER_LINEAR``), so the port needs no
OpenCV; the tests hold them against OpenCV.  :func:`resize_bilinear` is
the device resize of the SAM predictor's full-resolution paths, with
``jax.image.resize(..., "bilinear")``'s semantics; the tests hold it
against JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


ONE = 2048  # 1 << INTER_RESIZE_COEF_BITS: the uint8 path's fixed-point one


def _fixed_taps(dst: int, src: int, clamp_weight: bool):
    """:func:`_linear_taps` with the first tap's weight in OpenCV's 11-bit
    fixed point (the second's is ``ONE`` less it), as the uint8 path
    rounds it."""
    s0, s1, f = _linear_taps(dst, src, clamp_weight)
    return s0, s1, np.round((1.0 - f) * ONE).astype(np.int64)


def linear_taps_u8(src_hw: tuple[int, int], dst_hw: tuple[int, int]):
    """(sy0, sy1, ay0, sx0, sx1, ax0) int64: :func:`linear_resize`'s uint8
    path from ``src_hw`` to ``dst_hw`` as fixed-point taps, its branch
    chosen by the shapes as it chooses it.  The copy is taps (i, i, ONE)
    and the exact 2x reduction (2i, 2i + 1, ONE / 2) on both axes: with
    those, the taps' arithmetic gives the copy and the 2x2 mean rounded
    half up, byte for byte (no shift drops a bit)."""
    (Hs, Ws), (H, W) = src_hw, dst_hw
    if (Hs, Ws) == (H, W) or (Hs, Ws) == (2 * H, 2 * W):
        k = Hs // H
        taps = []
        for n in (H, W):
            i = np.arange(n, dtype=np.int64)
            taps += [k * i, k * i + k - 1, np.full(n, ONE // k, np.int64)]
        return tuple(taps)
    return (*_fixed_taps(H, Hs, clamp_weight=False), *_fixed_taps(W, Ws, clamp_weight=True))


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
    if x.dtype == np.uint8:
        sy, sy1, ay0 = _fixed_taps(H, Hs, clamp_weight=False)
        sx, sx1, ax0 = _fixed_taps(W, Ws, clamp_weight=True)
        ax0, ay0 = ax0[None, :, None], ay0[:, None, None]
        xi = x.astype(np.int64)
        hor = xi[:, sx] * ax0 + xi[:, sx1] * (ONE - ax0)
        out = (
            (((hor[sy] >> 4) * ay0) >> 16) + (((hor[sy1] >> 4) * (ONE - ay0)) >> 16) + 2
        ) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    sy, sy1, fy = _linear_taps(H, Hs, clamp_weight=False)
    sx, sx1, fx = _linear_taps(W, Ws, clamp_weight=True)
    wx = fx[None, :, None]
    wy = fy[:, None, None]
    hor = x[:, sx] * (1.0 - wx) + x[:, sx1] * wx
    return (hor[sy] * (1.0 - wy) + hor[sy1] * wy).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _triangle_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s bilinear
    kernel along one axis (``jax._src.image.scale.compute_weight_mat``, no
    translation, antialias on): a triangle over half-pixel centres,
    widened by 1 / scale when downsampling, each output's weights
    renormalised over the in-bounds taps.  Computed once per shape and
    device."""
    scale = n_out / n_in
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.float32(max(1.0 / scale, 1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, np.float32(0)).astype(np.float32)
    return torch.from_numpy(w).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(..., H, W) float32 -> (..., h, w) on ``x``'s device, as
    ``jax.image.resize(x, (..., h, w), "bilinear")`` resizes: separable
    weights (:func:`_triangle_weights`) contracted in float32, rows then
    columns; an axis whose size does not change is left as it is."""
    H, W = x.shape[-2:]
    h, w = out_hw
    if H != h:
        x = torch.matmul(_triangle_weights(H, h, x.device).T, x)
    if W != w:
        x = torch.matmul(x, _triangle_weights(W, w, x.device))
    return x
