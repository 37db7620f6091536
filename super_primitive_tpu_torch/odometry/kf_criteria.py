"""Keyframe gating criteria.

Port of ``super_primitive_tpu/odometry/kf_criteria.py``:
``translation_difference`` scales the translation gap by the median
rendered depth.  (``rotation_difference`` gates nothing in the reference
and is not ported.)
"""

from __future__ import annotations

import torch


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
