"""Bilinear image sampling with ``grid_sample(align_corners=True,
padding_mode='zeros')`` semantics on channels-last (H, W, C) images.

Port of ``super_primitive_tpu/ops/sampling.py``: pixel = (coord + 1)/2 *
(size - 1); out-of-range taps contribute zero; validity additionally needs
|coord_norm| <= 0.99 on both axes.  The packed form gathers the four taps of
a cell in one row gather.  The gradient half gives the value and the
analytic in-cell derivative with respect to the normalized coordinates from
the same four taps (the closed-form Jacobians of ``solve/gn_mapping.py``).

Packing contract: within the validity bound the cell origin is interior
(0 <= x0 <= W-2, likewise y), where packed and per-tap sampling agree bit
for bit.  Outside it the packed forms clamp the cell (exactly where the JAX
package clamps, in :func:`bilinear_cell_index`), so every index is in
bounds; callers mask those points by ``valid``.
"""

from __future__ import annotations

import torch

VALID_BOUND = 0.99


def _lerp(v00, v01, v10, v11, wx, wy):
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def _lerp_and_grad(v00, v01, v10, v11, wx, wy, H, W):
    """Bilinear combine and its in-cell derivative with respect to the
    normalized coordinates (chained through x_pix = (coord+1)/2 * (size-1))."""
    samples = _lerp(v00, v01, v10, v11, wx, wy)
    ddx = (v01 - v00) * (1.0 - wy) + (v11 - v10) * wy
    ddy = (v10 - v00) * (1.0 - wx) + (v11 - v01) * wx
    dval = torch.stack([ddx * (0.5 * (W - 1)), ddy * (0.5 * (H - 1))], dim=-1)
    return samples, dval


def _corner_taps(image: torch.Tensor, coords_norm: torch.Tensor):
    """The four taps (..., N, C) with out-of-range taps zeroed, the weights
    (..., N, 1) in the image dtype and the validity (..., N)."""
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

    return (tap(y0i, x0i), tap(y0i, x0i + 1), tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1),
            wx, wy, valid)


def bilinear_sample(
    image: torch.Tensor, coords_norm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample ``image`` (H, W, C) at normalized (x, y) coords (..., N, 2).

    Returns (samples (..., N, C), valid (..., N) bool)."""
    v00, v01, v10, v11, wx, wy, valid = _corner_taps(image, coords_norm)
    return _lerp(v00, v01, v10, v11, wx, wy), valid


def bilinear_sample_grad(
    image: torch.Tensor, coords_norm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample plus the exact piecewise derivative of the bilinear
    interpolant with respect to the normalized coordinates.

    Returns (samples (..., N, C), dval_dcoord (..., N, C, 2), valid (..., N))."""
    H, W, _ = image.shape
    v00, v01, v10, v11, wx, wy, valid = _corner_taps(image, coords_norm)
    samples, dval = _lerp_and_grad(v00, v01, v10, v11, wx, wy, H, W)
    return samples, dval, valid


def pack_bilinear_taps(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C) with channel blocks [v00 | v01 | v10 | v11]:
    the four taps of the cell whose origin is that pixel (zeros shift in at
    the last row/column)."""
    H, W, C = image.shape
    z_col = image.new_zeros((H, 1, C))
    z_row = image.new_zeros((1, W, C))
    right = torch.cat([image[:, 1:], z_col], dim=1)
    down = torch.cat([image[1:], z_row], dim=0)
    down_right = torch.cat([down[:, 1:], z_col], dim=1)
    return torch.cat([image, right, down, down_right], dim=-1)


def bilinear_cell_index(
    coords_norm: torch.Tensor, hw: tuple[int, int]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cell-origin row index, fractional weights and validity for a
    :func:`pack_bilinear_taps` image of shape ``hw``: the gather-free half
    of :func:`bilinear_sample_grad_packed`.

    Returns (lin_idx (..., N) int64 into the (H*W, 4C)-flattened packed
    image, clamped to an interior cell, wx (..., N), wy (..., N), valid
    (..., N) bool).  Callers that sample several images offset these
    indices into one flattened pool and gather once."""
    H, W = hw
    x = (coords_norm[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords_norm[..., 1] + 1.0) * 0.5 * (H - 1)
    valid = torch.all(torch.abs(coords_norm) <= VALID_BOUND, dim=-1)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x0i = x0.to(torch.int64).clamp(0, W - 2)
    y0i = y0.to(torch.int64).clamp(0, H - 2)
    return y0i * W + x0i, x - x0, y - y0, valid


def bilinear_grad_from_taps(
    taps: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, hw: tuple[int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Value and in-cell derivative from gathered packed taps (..., 4C) and
    :func:`bilinear_cell_index` weights.  Returns (samples (..., C),
    dval_dcoord (..., C, 2))."""
    H, W = hw
    C = taps.shape[-1] // 4
    wxc = wx[..., None].to(taps.dtype)
    wyc = wy[..., None].to(taps.dtype)
    return _lerp_and_grad(taps[..., 0 * C : 1 * C], taps[..., 1 * C : 2 * C],
                          taps[..., 2 * C : 3 * C], taps[..., 3 * C : 4 * C], wxc, wyc, H, W)


def _packed_taps(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather cell rows of one packed image (H, W, 4C), or of a stack
    (B, H, W, 4C) with each image's indices in the matching row of ``idx``
    (B, N)."""
    H, W, C4 = packed.shape[-3:]
    if packed.dim() == 4:
        idx = idx + torch.arange(packed.shape[0], device=idx.device)[:, None] * (H * W)
    return packed.reshape(-1, C4)[idx]


def bilinear_sample_grad_packed(
    packed: torch.Tensor, coords_norm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`bilinear_sample_grad` on a :func:`pack_bilinear_taps` image:
    identical to the unpacked version for every ``valid`` point; callers mask
    the rest.  A stack (B, H, W, 4C) samples each image at its own coords
    (B, N, 2)."""
    hw = tuple(packed.shape[-3:-1])
    idx, wx, wy, valid = bilinear_cell_index(coords_norm, hw)
    samples, dval = bilinear_grad_from_taps(_packed_taps(packed, idx), wx, wy, hw)
    return samples, dval, valid


def bilinear_sample_packed(
    packed: torch.Tensor, coords_norm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilinear_sample` on a :func:`pack_bilinear_taps` image: one
    row gather instead of four.  Agrees with the unpacked sampler exactly on
    ``valid`` points; callers mask the rest.  A stack of B packed images
    (B, H, W, 4C) samples each with its own coords (B, N, 2)."""
    hw = tuple(packed.shape[-3:-1])
    idx, wx, wy, valid = bilinear_cell_index(coords_norm, hw)
    taps = _packed_taps(packed, idx)
    C = taps.shape[-1] // 4
    wxc = wx[..., None].to(packed.dtype)
    wyc = wy[..., None].to(packed.dtype)
    samples = _lerp(taps[..., 0 * C : 1 * C], taps[..., 1 * C : 2 * C],
                    taps[..., 2 * C : 3 * C], taps[..., 3 * C : 4 * C], wxc, wyc)
    return samples, valid
