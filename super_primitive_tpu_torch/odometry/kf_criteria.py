"""Keyframe gating criteria.

Port of ``super_primitive_tpu/odometry/kf_criteria.py``:
``translation_difference`` scales the translation gap by the median
rendered depth.  (``rotation_difference`` gates nothing in the reference
and is not ported.)  ``render_kf_depth`` and ``gating_tensors`` are the
JAX package's ``odometry._render_kf_depth`` and ``_gating_metrics``, shared
here by the odometry loop and the fused frame step.

On a window sharded over sp each rank renders its points with empty
pixels at +inf, the renders combine by ``reduce_min`` and only then do
empty pixels become 0; the medians run on the replicated map.
"""

from __future__ import annotations

import torch

from ..cost import photometric as ph
from ..geometry import projection
from ..lie import se3
from ..ops.scatter import empty_to_zero, render_depth_min
from ..parallel.mesh import reduce_min


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values`` where ``mask``: the lower middle element for an
    even count (torch.median semantics)."""
    n = torch.sum(mask)
    big = torch.finfo(values.dtype).max
    sorted_vals = torch.sort(torch.where(mask, values, torch.full_like(values, big))).values
    idx = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, values.shape[0] - 1)
    return sorted_vals[idx]


def translation_difference(pose_src: torch.Tensor, pose_target: torch.Tensor,
                           depth: torch.Tensor):
    """Translation gap over the median valid rendered depth; ``depth`` is the
    scatter-rendered (H, W) map.  Returns (difference, median depth)."""
    flat = depth.reshape(-1)
    scale = masked_median(flat, flat > 1e-6)
    diff = torch.linalg.norm(pose_src[:3, 3] - pose_target[:3, 3])
    return diff / (scale + 1e-6), scale


def render_kf_depth(buffers, kf_slot: int, pose: torch.Tensor, geo_dims) -> torch.Tensor:
    """Render keyframe ``kf_slot``'s points into the camera at world pose
    ``pose`` (min z-buffer), an (H, W) depth map."""
    bundle = buffers.bundle_at(kf_slot)
    delta = se3.inverse(pose) @ buffers.poses[kf_slot]
    logd = ph.spread_logdepth(bundle, buffers.kp_logdepth[kf_slot], buffers.kp_base[kf_slot])
    pts = projection.unproject(bundle.uv, torch.exp(logd), buffers.K[kf_slot])
    pts = projection.transform(pts, delta)
    depth, _ = render_depth_min(pts, buffers.K[kf_slot], geo_dims, valid=bundle.valid)
    return empty_to_zero(reduce_min(depth, bundle.group))


def gating_tensors(buffers, kf_slot: int, pose: torch.Tensor, geo_dims) -> torch.Tensor:
    """Keyframe gating at ``pose`` on the device, (3,): the share of valid
    pixels in the last keyframe's render, the median-depth-scaled
    translation gap and the median depth."""
    depth = render_kf_depth(buffers, kf_slot, pose, geo_dims)
    validity_ratio = torch.mean((depth > 1e-6).to(torch.float32))
    diff, scale = translation_difference(pose, buffers.poses[kf_slot], depth)
    return torch.stack([validity_ratio, diff, scale])
