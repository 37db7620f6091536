"""Segment-based depth completion.

Port of ``super_primitive_tpu/depth_completion/completion.py``: the sparse
depth pixels become the frontend's query keypoints; each segment the
frontend returns takes the median log-depth shift against the sparse depth
(``odometry.depth_init.segment_based_depth_reinit``); the segments' depths
are formed densely and overlapping segments averaged.  Where more than
``invalid_ratio_thresh`` of the pixels stay invalid, a second, loose pass
(SAM without NMS and without the smallest-good pick) fills them.  No
optimisation loop: frontend and median alignment only.

The dense part (``exp`` of the shifted log-depths, the -1 fill outside each
segment, the overlap average) runs in PyTorch on the frontend's
``device``: at 480x640 and a few hundred segments it is an (N, H, W)
stack of several hundred MB.  What :class:`DepthCompletion` returns is
numpy, as the JAX class returns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..odometry.depth_init import segment_based_depth_reinit
from ..utils import timing


def render_depth_avg(depths: torch.Tensor):
    """Average (N, H, W) per-segment depth maps over the overlapping valid
    (> 1e-6) pixels; returns (depth (H, W) float32, invalid (H, W) bool),
    tensors on the input's device."""
    if depths.shape[0] == 0:
        H, W = depths.shape[1:]
        return (torch.zeros((H, W), dtype=torch.float32, device=depths.device),
                torch.ones((H, W), dtype=torch.bool, device=depths.device))
    invalid = depths.amax(dim=0) < 1e-6
    d = torch.where(depths < 1e-6, torch.zeros_like(depths), depths)
    count = (d > 1e-6).sum(dim=0).to(torch.float64) + 1e-6
    return (d.sum(dim=0).to(torch.float64) / count).to(torch.float32), invalid


def infer_depth(frontend, image, keypoints_norm, K, sparse_depth, rerun=False, timer=None,
                segments=None):
    """One completion pass: the frontend's keyframe for the prompts
    ``keypoints_norm``, each segment aligned to ``sparse_depth`` by its
    median shift, the visible segments' depths averaged on the frontend's
    ``device``.  Returns (depth, invalid) as tensors there; appends
    (segments, visible segments) to ``segments`` when given."""
    kf = frontend.process_to_kf(image, K, keypoints=keypoints_norm, loose=rerun)
    regions = kf["regions"]
    logdepth = kf["logdepth_perseg"]
    kp_rc = kf["keypoints_rc"]
    with timing.span(timer, "depth_reinit"):
        kp_logdepth, visible = segment_based_depth_reinit(
            sparse_depth, regions, logdepth, kp_rc, mode="median", return_info=True)
        shift = kp_logdepth - logdepth[np.arange(len(kp_rc)), kp_rc[:, 0], kp_rc[:, 1]]
    if segments is not None:
        segments.append((int(regions.shape[0]), int(visible.sum())))
    with timing.span(timer, "render_avg"):
        device = frontend.device
        idx = np.nonzero(visible)[0]
        ld = torch.from_numpy(np.ascontiguousarray(logdepth[idx])).to(device)
        reg = torch.from_numpy(np.ascontiguousarray(regions[idx])).to(device)
        sh = torch.from_numpy(shift[idx].astype(np.float32)).to(device)
        depths = torch.where(reg, torch.exp(ld + sh[:, None, None]),
                             torch.full_like(ld, -1.0))
        return render_depth_avg(depths)


class DepthCompletion:
    """Depth completion through ``frontend`` (a ``FrontProcessor`` or a stub
    with its ``process_to_kf(image, K, keypoints, loose)`` and a
    ``device``, where the dense part runs).  ``timer``: an
    optional ``utils.timing.StageTimer`` for the completion's own stages
    (``depth_reinit``, ``render_avg``, ``loose_rerun``).  ``segments``
    holds the last call's (segments, visible segments) of each pass."""

    def __init__(self, frontend, invalid_ratio_thresh: float = 0.15, timer=None):
        self.frontend = frontend
        self.invalid_ratio_thresh = invalid_ratio_thresh
        self.timer = timer
        self.segments: list[tuple[int, int]] = []

    def depth_completion(self, image, K, sparse_depth):
        """(depth (H, W) float32, invalid (H, W) bool), numpy."""
        sparse_depth = np.asarray(sparse_depth, np.float32)
        H, W = sparse_depth.shape
        r, c = np.nonzero(sparse_depth > 1e-6)
        dims = np.asarray([H, W], np.float32)
        keypoints_norm = 2.0 * np.stack([r, c], axis=1).astype(np.float32) / (dims - 1) - 1.0

        self.segments = []
        depths, invalid = infer_depth(self.frontend, image, keypoints_norm, K, sparse_depth,
                                      timer=self.timer, segments=self.segments)
        invalid_ratio = float(timing.to_host(invalid.sum())) / invalid.numel()
        if invalid_ratio > self.invalid_ratio_thresh:
            with timing.span(self.timer, "loose_rerun"):
                depths_new, invalid_new = infer_depth(
                    self.frontend, image, keypoints_norm, K, sparse_depth, rerun=True,
                    timer=self.timer, segments=self.segments)
                depths = torch.where(invalid, depths_new, depths)
                invalid = invalid & invalid_new
        return timing.to_host(depths), timing.to_host(invalid)
