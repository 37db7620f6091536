"""Segment-based depth (re-)initialisation.

Port of ``super_primitive_tpu/odometry/depth_init.py`` (the median mode
the odometry loop uses): each segment's keypoint log-depth is set from the median
shift between an
estimated depth map (rendered from the previous keyframe, or ground truth)
and the segment's frozen log-depth, plus the frozen log-depth at the
keypoint; segments with no valid estimate get the median over the visible
ones.  Host numpy, once per keyframe.
"""

from __future__ import annotations

import numpy as np


def _lower_median(x: np.ndarray) -> float:
    """torch.median semantics: the lower middle element for even counts."""
    s = np.sort(x.reshape(-1))
    return float(s[(s.size - 1) // 2])


def segment_based_depth_reinit(estimated_depth: np.ndarray, regions: np.ndarray,
                               logdepth_perseg: np.ndarray,
                               keypoints_rc: np.ndarray) -> np.ndarray:
    """Per-segment keypoint log-depths (median mode) from an estimated
    (H, W) depth map.  ``regions`` (N, H, W) bool, ``logdepth_perseg``
    (N, H, W), ``keypoints_rc`` (N, 2) integer (row, col)."""
    eps = 1e-6
    est = np.asarray(estimated_depth, np.float32).copy()
    valid_est = est >= eps
    est[~valid_est] = eps
    est_log = np.log(est)

    N = regions.shape[0]
    shifts = est_log[None] - logdepth_perseg
    valid_regions = regions & valid_est[None]
    visible = valid_regions.reshape(N, -1).sum(axis=1) > 0
    kp_base = logdepth_perseg[np.arange(N), keypoints_rc[:, 0], keypoints_rc[:, 1]]

    out = np.zeros(N, np.float32)
    for i in np.nonzero(visible)[0]:
        out[i] = _lower_median(shifts[i][valid_regions[i]]) + kp_base[i]
    if visible.any():
        out[~visible] = _lower_median(out[visible])
    return out
