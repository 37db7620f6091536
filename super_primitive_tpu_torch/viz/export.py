"""Run artifacts: point clouds, residual heatmaps and trajectory plots.

Port of ``super_primitive_tpu/viz/export.py`` on numpy alone (no OpenCV and
no matplotlib, which the card's host does not have):

- ``save_ply`` and ``keyframe_pointcloud``: the same code, so the same
  bytes;
- ``save_residual_png``: the |residual| heatmap through the 256-entry
  inferno table that OpenCV's ``COLORMAP_INFERNO`` applies (copied from
  OpenCV once, below), written with ``data.image_io.write_png``: the file's
  RGB pixels are the ones OpenCV writes;
- ``save_trajectory_plot``: the top-down (x, z) plot of named
  trajectories with equal axes, one colour each, rasterised with numpy into
  a PNG (its pixels are not matplotlib's; it has no text).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.image_io import write_png

# OpenCV's COLORMAP_INFERNO as (256, 3) RGB: row i is the colour of level i
_INFERNO_RGB = bytes.fromhex(
    "00000401000501010601010802010a02020c02020e030210040312040314050417060419"
    "07051b08051d09061f0a07220b07240c08260d08290e092b10092d110a30120a32140b34"
    "150b37160b39180c3c190c3e1b0c411c0c431e0c451f0c48210c4a230c4c240c4f260c51"
    "280b53290b552b0b572d0b592f0a5b310a5c320a5e340a5f3609613809623909633b0964"
    "3d09653e0966400a67420a68440a68450a69470b6a490b6a4a0c6b4c0c6b4d0d6c4f0d6c"
    "510e6c520e6d540f6d550f6d57106e59106e5a116e5c126e5d126e5f136e61136e62146e"
    "64156e65156e67166e69166e6a176e6c186e6d186e6f196e71196e721a6e741a6e751b6e"
    "771c6d781c6d7a1d6d7c1d6d7d1e6d7f1e6c801f6c82206c84206b85216b87216b88226a"
    "8a226a8c23698d23698f24699025689225689326679526679727669827669a28659b2964"
    "9d29649f2a63a02a63a22b62a32c61a52c60a62d60a82e5fa92e5eab2f5ead305dae305c"
    "b0315bb1325ab3325ab43359b63458b73557b93556ba3655bc3754bd3853bf3952c03a51"
    "c13a50c33b4fc43c4ec63d4dc73e4cc83f4bca404acb4149cc4248ce4347cf4446d04545"
    "d24644d34743d44842d54a41d74b3fd84c3ed94d3dda4e3cdb503bdd513ade5238df5337"
    "e05536e15635e25734e35933e45a31e55c30e65d2fe75e2ee8602de9612bea632aeb6429"
    "eb6628ec6726ed6925ee6a24ef6c23ef6e21f06f20f1711ff1731df2741cf3761bf37819"
    "f47918f57b17f57d15f67e14f68013f78212f78410f8850ff8870ef8890cf98b0bf98c0a"
    "f98e09fa9008fa9207fa9407fb9606fb9706fb9906fb9b06fb9d07fc9f07fca108fca309"
    "fca50afca60cfca80dfcaa0ffcac11fcae12fcb014fcb216fcb418fbb61afbb81dfbba1f"
    "fbbc21fbbe23fac026fac228fac42afac62df9c72ff9c932f9cb35f8cd37f8cf3af7d13d"
    "f7d340f6d543f6d746f5d949f5db4cf4dd4ff4df53f4e156f3e35af3e55df2e661f2e865"
    "f2ea69f1ec6df1ed71f1ef75f1f179f2f27df2f482f3f586f3f68af4f88ef5f992f6fa96"
    "f8fb9af9fc9dfafda1fcffa4"
)
INFERNO_RGB = np.frombuffer(_INFERNO_RGB, np.uint8).reshape(256, 3)

# matplotlib's default colour cycle (tab10), one colour a trajectory
TRAJECTORY_COLORS = np.array([
    [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40], [148, 103, 189],
    [140, 86, 75], [227, 119, 194], [127, 127, 127], [188, 189, 34], [23, 190, 207],
], np.uint8)


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud; colors float [0, 1] or uint8."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            line = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if has_color:
                line += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
            f.write(line + "\n")
    return path


def keyframe_pointcloud(bundle_uv: np.ndarray, depth: np.ndarray, K: np.ndarray,
                        pose: np.ndarray, colors: Optional[np.ndarray] = None,
                        valid: Optional[np.ndarray] = None):
    """Lift bundle pixels (u, v) at ``depth`` to world points through the
    intrinsics ``K`` and the world-from-camera ``pose``; keep ``valid``."""
    K = np.asarray(K)
    uv = np.asarray(bundle_uv)
    z = np.asarray(depth)
    x = (uv[:, 0] - K[0, 2]) * z / K[0, 0]
    y = (uv[:, 1] - K[1, 2]) * z / K[1, 1]
    pts = np.stack([x, y, z], axis=1)
    T = np.asarray(pose)
    pts_w = pts @ T[:3, :3].T + T[:3, 3]
    if valid is not None:
        pts_w = pts_w[valid]
        colors = colors[valid] if colors is not None else None
    return pts_w, colors


def save_residual_png(path: str, residual_img: np.ndarray, scale: float = 4.0):
    """Save |residual| x ``scale``, clipped to [0, 1] (the channel mean of a
    colour residual), as an inferno heatmap PNG."""
    r = np.clip(np.abs(np.asarray(residual_img)) * scale, 0, 1)
    if r.ndim == 3:
        r = r.mean(axis=-1)
    img = (r * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, INFERNO_RGB[img])
    return path


def _draw_polyline(canvas: np.ndarray, rows: np.ndarray, cols: np.ndarray, color,
                   width: int = 2) -> None:
    """Stamp a ``width``-pixel square brush along each segment, one stamp
    per pixel of its length."""
    H, W = canvas.shape[:2]
    rr, cc = [rows[:1]], [cols[:1]]
    for r0, c0, r1, c1 in zip(rows[:-1], cols[:-1], rows[1:], cols[1:]):
        n = int(np.ceil(max(abs(r1 - r0), abs(c1 - c0)))) + 1
        t = np.linspace(0.0, 1.0, n)
        rr.append(r0 + t * (r1 - r0))
        cc.append(c0 + t * (c1 - c0))
    r = np.round(np.concatenate(rr)).astype(int)
    c = np.round(np.concatenate(cc)).astype(int)
    for dr in range(width):
        for dc in range(width):
            canvas[np.clip(r + dr - width // 2, 0, H - 1),
                   np.clip(c + dc - width // 2, 0, W - 1)] = color


def save_trajectory_plot(path: str, trajectories: dict, title: str = "trajectory",
                         size: int = 600, margin: int = 40):
    """Top-down (x, z) plot of named trajectories {label: {ts: 4x4 pose}},
    frame-id order, equal axes, one colour each (``TRAJECTORY_COLORS`` in
    order; a swatch per trajectory at the top left), as a ``size`` x
    ``size`` RGB PNG.  ``title`` is kept for the JAX signature: the raster
    has no text."""
    del title
    paths = []
    for traj in trajectories.values():
        keys = sorted(traj.keys(), key=lambda s: int(s))
        t = np.stack([np.asarray(traj[k], np.float64)[:3, 3] for k in keys])
        paths.append(t[:, [0, 2]])
    canvas = np.full((size, size, 3), 255, np.uint8)
    inner = size - 2 * margin
    canvas[margin - 1:size - margin + 1, [margin - 1, size - margin]] = 0
    canvas[[margin - 1, size - margin], margin - 1:size - margin + 1] = 0
    if paths:
        allp = np.concatenate(paths)
        lo, hi = allp.min(axis=0), allp.max(axis=0)
        span = float((hi - lo).max()) or 1.0
        centre = (lo + hi) / 2
        for i, p in enumerate(paths):
            color = TRAJECTORY_COLORS[i % len(TRAJECTORY_COLORS)]
            u = (p - centre) / span + 0.5  # equal axes: one scale for x and z
            cols = margin + u[:, 0] * (inner - 1)
            rows = margin + (1.0 - u[:, 1]) * (inner - 1)  # z up
            _draw_polyline(canvas, rows, cols, color)
            y0 = 8 + 14 * i
            canvas[y0:y0 + 10, 8:28] = color
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, canvas)
    return path
