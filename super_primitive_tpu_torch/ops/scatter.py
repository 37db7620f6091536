"""Scatter depth rendering with a min z-buffer.

Port of ``super_primitive_tpu/ops/scatter.py`` (``render_depth``): project
points, truncate to integer pixels, keep the nearest z per pixel.  The
minimum does not depend on the order of the scatter, so the result is exact
on the card as on the CPU.  :func:`render_depth_min` keeps empty pixels at
+inf, the encoding in which renders of disjoint point sets combine by an
elementwise minimum.
"""

from __future__ import annotations

import torch

from ..geometry import projection

Z_VALID = 1e-6


def render_depth_min(points: torch.Tensor, K: torch.Tensor, dims: tuple[int, int],
                     valid: torch.Tensor | None = None):
    """:func:`render_depth` with pixels that no point reaches at +inf.
    Returns (depth (H, W), point_valid (P,))."""
    H, W = dims
    z = points[..., 2]
    ok = z > Z_VALID
    if valid is not None:
        ok = ok & valid
    uv = projection.project(points, K)
    col = uv[..., 0].to(torch.int64)
    row = uv[..., 1].to(torch.int64)
    ok = ok & (row >= 0) & (row < H) & (col >= 0) & (col < W)
    idx = torch.where(ok, row * W + col, torch.full_like(row, H * W))  # overflow slot
    buf = torch.full((H * W + 1,), torch.inf, dtype=points.dtype, device=points.device)
    buf = buf.scatter_reduce(0, idx, torch.where(ok, z, torch.full_like(z, torch.inf)),
                             reduce="amin")
    return buf[: H * W].reshape(H, W), ok


def empty_to_zero(depth: torch.Tensor) -> torch.Tensor:
    """Map :func:`render_depth_min`'s empty pixels (+inf) to 0."""
    return torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)


def render_depth(points: torch.Tensor, K: torch.Tensor, dims: tuple[int, int],
                 valid: torch.Tensor | None = None):
    """Scatter-render (P, 3) camera-frame points into an (H, W) depth image.

    Returns (depth (H, W), point_valid (P,)); pixels with no point are 0.
    (row, col) = (int(v), int(u)), truncation toward zero."""
    depth, ok = render_depth_min(points, K, dims, valid)
    return empty_to_zero(depth), ok
