"""KeyFrame, its segment geometry and the fixed-capacity PointBundle.

Port of ``super_primitive_tpu/keyframe.py``.  A keyframe holds an image
(H, W, C) channels-last float32 in [0, 1], the geometry intrinsics ``K``,
display intrinsics ``K_img`` and, for non-supporting frames, per-segment
frozen log-depth maps (N, Hg, Wg), keypoints (N, 2) normalized (row, col)
and boolean regions (N, Hg, Wg).

Region masks are constant during optimization, so their pixels are
extracted once per keyframe into a :class:`PointBundle` of flat arrays
padded to a static capacity with a validity mask.  The residual's mean
keeps the reference denominator: channels x region points (padding
excluded).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .geometry.coords import denormalize_coords
from .image import pyramid as pyr


@dataclasses.dataclass
class SegmentGeometry:
    """Per-segment frozen geometry, padded to a segment capacity N."""

    keypoints: torch.Tensor     # (N, 2) normalized (row, col) in [-1, 1]
    logdepth: torch.Tensor      # (N, Hg, Wg) frozen log-depth (0 outside region)
    regions: torch.Tensor       # (N, Hg, Wg) bool
    seg_valid: torch.Tensor     # (N,) bool

    @property
    def num_segments(self) -> int:
        return self.keypoints.shape[0]

    @property
    def geo_dims(self) -> tuple[int, int]:
        return self.logdepth.shape[1], self.logdepth.shape[2]

    def keypoint_pixels(self) -> torch.Tensor:
        """Denormalized integer keypoint (row, col) pixels (N, 2)."""
        return denormalize_coords(self.keypoints, self.geo_dims)

    def keypoint_base_logdepth(self) -> torch.Tensor:
        """Frozen log-depth at each segment's keypoint pixel (N,)."""
        rc = self.keypoint_pixels()
        n = torch.arange(self.num_segments, device=rc.device)
        return self.logdepth[n, rc[:, 0], rc[:, 1]]


@dataclasses.dataclass
class PointBundle:
    """Flattened region pixels of one keyframe, padded to capacity P.
    ``num_valid`` is the true region-point count (the residual denominator)."""

    uv: torch.Tensor             # (P, 2) float32, (u, v) = (col, row)
    seg_id: torch.Tensor         # (P,) int64 (0 for padding)
    base_logdepth: torch.Tensor  # (P,) float32 frozen log-depth at the pixel
    valid: torch.Tensor          # (P,) bool, False for padding
    num_valid: int

    # a bundle holds all its points: no global offset, nothing to reduce
    # over (``parallel.mesh.ShardedBundle`` holds a range of them)
    start = 0
    group = None

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


@dataclasses.dataclass
class KeyFrame:
    """One frame: image + intrinsics (+ segment geometry unless supporting)."""

    image: torch.Tensor
    K: torch.Tensor
    K_img: torch.Tensor
    geo: Optional[SegmentGeometry] = None


@dataclasses.dataclass
class KeyFramePyramid:
    """Coarse-to-fine image pyramid of one keyframe.  Geometry is shared
    across levels: only images and K_img shrink; sampling uses normalized
    coordinates, so the same bundle drives every level."""

    images: list[torch.Tensor]    # coarsest-first
    Ks_img: list[torch.Tensor]    # coarsest-first
    K: torch.Tensor
    geo: Optional[SegmentGeometry]
    bundle: Optional[PointBundle]

    @property
    def num_levels(self) -> int:
        return len(self.images)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_bundle_np(
    regions: np.ndarray,
    logdepth: np.ndarray,
    capacity: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> PointBundle:
    """Extract the point bundle on the host, once per keyframe, padded to
    ``capacity`` (default: the point count rounded up to 1024).

    Points are ordered (seg, row, col) lexicographically; coords become
    (u, v) = (col, row)."""
    regions = np.asarray(regions)
    logdepth = np.asarray(logdepth)
    b, r, c = np.nonzero(regions)
    n = b.shape[0]
    cap = capacity if capacity is not None else round_up(max(n, 1), 1024)
    if n > cap:
        raise ValueError(f"bundle capacity {cap} < {n} region points")

    uv = np.zeros((cap, 2), np.float32)
    uv[:n, 0] = c
    uv[:n, 1] = r
    seg_id = np.zeros((cap,), np.int64)
    seg_id[:n] = b
    base = np.zeros((cap,), np.float32)
    base[:n] = logdepth[b, r, c]
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return PointBundle(
        uv=torch.from_numpy(uv).to(device),
        seg_id=torch.from_numpy(seg_id).to(device),
        base_logdepth=torch.from_numpy(base).to(device),
        valid=torch.from_numpy(valid).to(device),
        num_valid=int(n),
    )


def keyframe_pyramid(
    kf: KeyFrame,
    start_level: int,
    end_level: int,
    bundle: Optional[PointBundle] = None,
) -> KeyFramePyramid:
    """Build the coarse-to-fine pyramid: images blurred+downsampled per
    level, K_img rescaled, geometry shared at base resolution.  Without a
    given ``bundle`` one is extracted from ``kf.geo`` with capacity
    round_up(2*Hg*Wg, 1024), as the reference sizes it."""
    images = pyr.image_pyramid(kf.image, start_level, end_level)
    Ks_img = pyr.intrinsics_pyramid(kf.K_img, start_level, end_level)
    if bundle is None and kf.geo is not None:
        H, W = kf.geo.geo_dims
        bundle = build_bundle_np(
            kf.geo.regions.cpu().numpy(), kf.geo.logdepth.cpu().numpy(),
            capacity=round_up(2 * H * W, 1024), device=kf.image.device,
        )
    return KeyFramePyramid(images=images, Ks_img=Ks_img, K=kf.K, geo=kf.geo, bundle=bundle)


def _nearest_pixel(mask: np.ndarray, r: int, c: int) -> tuple[int, int]:
    """The pixel of a non-empty (H, W) ``mask`` nearest to (r, c), ties to
    the first in row-major order.  Searched in square windows that grow 4x:
    once the window's nearest pixel lies within its half-width R, every
    pixel outside the window is farther (|dr| or |dc| > R), so the window's
    first nearest pixel is the frame's."""
    H, W = mask.shape
    R = 8
    while True:
        r0, r1, c0, c1 = max(0, r - R), min(H, r + R + 1), max(0, c - R), min(W, c + R + 1)
        whole = r0 == 0 and c0 == 0 and r1 == H and c1 == W
        rr, cc = np.nonzero(mask[r0:r1, c0:c1])
        if rr.size:
            d2 = (rr + r0 - r) ** 2 + (cc + c0 - c) ** 2
            j = int(np.argmin(d2))
            if whole or d2[j] <= R * R:
                return int(rr[j]) + r0, int(cc[j]) + c0
        elif whole:
            raise ValueError("_nearest_pixel: the mask is empty")
        R *= 4


def put_keypoints_back(
    keypoints: np.ndarray, regions: np.ndarray, logdepth: Optional[np.ndarray] = None
):
    """Snap keypoints to the nearest valid region pixel and drop empty
    segments (host side, once per keyframe).  Ties go to the first pixel in
    row-major order."""
    keypoints = np.asarray(keypoints)
    regions = np.asarray(regions).astype(bool)
    N, H, W = regions.shape
    dims = np.asarray([H, W], np.float32)
    kp_px = np.round(0.5 * (dims - 1.0) * (keypoints + 1.0)).astype(np.int64)

    good = regions.reshape(N, -1).sum(axis=1) > 0
    kp_px = kp_px[good]
    regions = regions[good]
    if logdepth is not None:
        logdepth = np.asarray(logdepth)[good]

    M = kp_px.shape[0]
    out = kp_px.copy()
    in_mask = regions[np.arange(M), kp_px[:, 0], kp_px[:, 1]] if M else np.zeros(0, bool)
    for i in np.nonzero(~in_mask)[0]:
        out[i] = _nearest_pixel(regions[i], int(kp_px[i, 0]), int(kp_px[i, 1]))
    new_kp = (2.0 * out / (dims - 1.0) - 1.0).astype(np.float32)
    if logdepth is not None:
        return new_kp, regions, logdepth
    return new_kp, regions


def make_segment_geometry(
    keypoints: np.ndarray,
    regions: np.ndarray,
    logdepth: np.ndarray,
    device: str | torch.device = "cuda",
) -> SegmentGeometry:
    """Pack host-side per-segment arrays into a SegmentGeometry on
    ``device``."""
    keypoints = np.asarray(keypoints, np.float32)
    regions = np.asarray(regions, bool)
    logdepth = np.asarray(logdepth, np.float32) * regions  # zero outside regions
    return SegmentGeometry(
        keypoints=torch.tensor(keypoints, device=device),
        logdepth=torch.tensor(logdepth, device=device),
        regions=torch.tensor(regions, device=device),
        seg_valid=torch.ones(keypoints.shape[0], dtype=torch.bool, device=device),
    )
