"""Scatter depth rendering with a min z-buffer.

Port of ``super_primitive_tpu/ops/scatter.py`` (``render_depth``): project
points, truncate to integer pixels, keep the nearest z per pixel.  The
minimum does not depend on the order of the scatter, so the result is exact
on the card as on the CPU.
"""

from __future__ import annotations

import torch

from ..geometry import projection

Z_VALID = 1e-6


def render_depth(points: torch.Tensor, K: torch.Tensor, dims: tuple[int, int],
                 valid: torch.Tensor | None = None):
    """Scatter-render (P, 3) camera-frame points into an (H, W) depth image.

    Returns (depth (H, W), point_valid (P,)); pixels with no point are 0.
    (row, col) = (int(v), int(u)), truncation toward zero."""
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
    depth = buf[: H * W]
    depth = torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
    return depth.reshape(H, W), ok
