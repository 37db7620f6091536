"""Bilinear image sampling with ``grid_sample(align_corners=True,
padding_mode='zeros')`` semantics on channels-last (H, W, C) images.

Port of ``super_primitive_tpu/ops/sampling.py``: pixel = (coord + 1)/2 *
(size - 1); out-of-range taps contribute zero; validity additionally needs
|coord_norm| <= 0.99 on both axes.  The packed form gathers the four taps of
a cell in one row gather.
"""

from __future__ import annotations

import torch

VALID_BOUND = 0.99


def _lerp(v00, v01, v10, v11, wx, wy):
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def bilinear_sample(
    image: torch.Tensor, coords_norm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample ``image`` (H, W, C) at normalized (x, y) coords (..., N, 2).

    Returns (samples (..., N, C), valid (..., N) bool)."""
    H, W, C = image.shape
    x = (coords_norm[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords_norm[..., 1] + 1.0) * 0.5 * (H - 1)
    valid = torch.all(torch.abs(coords_norm) <= VALID_BOUND, dim=-1)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None].to(image.dtype)
    wy = (y - y0)[..., None].to(image.dtype)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = image.reshape(H * W, C)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[idx] * inb[..., None].to(image.dtype)

    samples = _lerp(
        tap(y0i, x0i), tap(y0i, x0i + 1), tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1),
        wx, wy,
    )
    return samples, valid


def pack_bilinear_taps(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C) with channel blocks [v00 | v01 | v10 | v11]:
    the four taps of the cell whose origin is that pixel (zeros shift in at
    the last row/column).  Within the |coord| <= 0.99 bound the cell origin
    is interior, where packed and per-tap sampling agree bit for bit."""
    H, W, C = image.shape
    z_col = image.new_zeros((H, 1, C))
    z_row = image.new_zeros((1, W, C))
    right = torch.cat([image[:, 1:], z_col], dim=1)
    down = torch.cat([image[1:], z_row], dim=0)
    down_right = torch.cat([down[:, 1:], z_col], dim=1)
    return torch.cat([image, right, down, down_right], dim=-1)


def bilinear_sample_packed(
    packed: torch.Tensor, coords_norm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilinear_sample` on a :func:`pack_bilinear_taps` image: one
    row gather instead of four.  Agrees with the unpacked sampler exactly on
    ``valid`` points; callers mask the rest.  A stack of B packed images
    (B, H, W, 4C) samples each with its own coords (B, N, 2)."""
    H, W, C4 = packed.shape[-3:]
    C = C4 // 4
    x = (coords_norm[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords_norm[..., 1] + 1.0) * 0.5 * (H - 1)
    valid = torch.all(torch.abs(coords_norm) <= VALID_BOUND, dim=-1)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None].to(packed.dtype)
    wy = (y - y0)[..., None].to(packed.dtype)
    x0i = x0.to(torch.int64).clamp(0, W - 2)
    y0i = y0.to(torch.int64).clamp(0, H - 2)
    idx = y0i * W + x0i
    if packed.dim() == 4:
        idx = idx + torch.arange(packed.shape[0], device=idx.device)[:, None] * (H * W)
    taps = packed.reshape(-1, C4)[idx]
    samples = _lerp(
        taps[..., 0 * C : 1 * C], taps[..., 1 * C : 2 * C],
        taps[..., 2 * C : 3 * C], taps[..., 3 * C : 4 * C], wx, wy,
    )
    return samples, valid
