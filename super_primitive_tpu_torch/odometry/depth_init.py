"""Segment-based depth (re-)initialisation.

Port of ``super_primitive_tpu/odometry/depth_init.py``: each segment's
keypoint log-depth is set from the median (or mean) shift between an
estimated depth map (rendered from the previous keyframe, ground truth, or
a sparse depth map) and the segment's frozen log-depth, plus the frozen
log-depth at the keypoint; segments with no valid estimate get the median
over the visible ones.  Host numpy, once per keyframe or completion pass.
"""

from __future__ import annotations

import numpy as np


def _lower_median(x: np.ndarray) -> float:
    """torch.median semantics: the lower middle element for even counts."""
    s = np.sort(x.reshape(-1))
    return float(s[(s.size - 1) // 2])


def segment_based_depth_reinit(estimated_depth: np.ndarray, regions: np.ndarray,
                               logdepth_perseg: np.ndarray, keypoints_rc: np.ndarray,
                               mode: str = "median", return_info: bool = False):
    """Per-segment keypoint log-depths from an estimated (H, W) depth map.

    ``regions`` (N, H, W) bool, ``logdepth_perseg`` (N, H, W),
    ``keypoints_rc`` (N, 2) integer (row, col).  With ``return_info`` also
    returns ``visible`` (N,), the segments with a valid estimate.

    The shifts are formed only at the pixels where the estimate is valid
    (a sparse depth map has a few hundred), which gives the same set of
    values, so the same median, as the full (N, H, W) stack; the mean sums
    over the full stack, in the JAX package's order."""
    if mode not in ("mean", "median"):
        raise ValueError(f"unknown mode {mode!r}; use mean or median")
    eps = 1e-6
    est = np.asarray(estimated_depth, np.float32).copy()
    valid_est = est >= eps
    est[~valid_est] = eps
    est_log = np.log(est)

    N = regions.shape[0]
    kp_base = logdepth_perseg[np.arange(N), keypoints_rc[:, 0], keypoints_rc[:, 1]]
    out = np.zeros(N, np.float32)
    if mode == "mean":
        shifts = est_log[None] - logdepth_perseg
        valid_regions = regions & valid_est[None]
        num_valid = valid_regions.reshape(N, -1).sum(axis=1)
        visible = num_valid > 0
        sums = (shifts * valid_regions).reshape(N, -1).sum(axis=1)
        out[visible] = sums[visible] / num_valid[visible] + kp_base[visible]
    else:
        pix = np.flatnonzero(valid_est)
        shifts = est_log.reshape(-1)[pix][None] - logdepth_perseg.reshape(N, -1)[:, pix]
        valid_regions = regions.reshape(N, -1)[:, pix]
        visible = valid_regions.any(axis=1)
        for i in np.nonzero(visible)[0]:
            out[i] = _lower_median(shifts[i][valid_regions[i]]) + kp_base[i]
    if visible.any():
        out[~visible] = _lower_median(out[visible])
    if return_info:
        return out, visible
    return out
