"""Stub frontends for checkpoint-free runs: keyframe geometry from GT depth.

Port of ``super_primitive_tpu/frontend/stub.py`` (``GridSegmentFrontend``
for odometry, ``PatchSegmentFrontend`` for depth completion): the solvers
and the completion run on frontend outputs synthesized from ground-truth
depth, isolated from the networks.  Host numpy only.
"""

from __future__ import annotations

import numpy as np
import torch


class GridSegmentFrontend:
    """Builds keyframe geometry from GT depth with a regular segment grid —
    a drop-in for ``FrontProcessorNew`` that needs no SAM/normal nets.

    ``process_to_kf`` returns the dict the odometry loop consumes:
    image (H, W, C float32 [0,1]), K, regions (N, H, W), logdepth_perseg,
    keypoints_rc (N, 2 int).
    """

    def __init__(self, rows: int = 6, cols: int = 8, downsample_pow: int = 0):
        self.rows = rows
        self.cols = cols
        self.downsample_pow = downsample_pow

    def _downsample(self, image: np.ndarray, K: np.ndarray):
        s = 2 ** self.downsample_pow
        if s == 1:
            return image, np.asarray(K, np.float32)
        img = image[::s, ::s]
        K2 = np.asarray(K, np.float64).copy()
        K2[:2] /= s
        return img, K2.astype(np.float32)

    def process_to_kf(self, image: np.ndarray, K: np.ndarray) -> dict:
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        img, K = self._downsample(img, K)
        H, W = img.shape[:2]
        depth = self._depth
        s = depth.shape[0] // H
        if s > 1:
            depth = depth[::s, ::s][:H, :W]

        N = self.rows * self.cols
        regions = np.zeros((N, H, W), bool)
        kp_rc = np.zeros((N, 2), np.int64)
        hs, ws = H // self.rows, W // self.cols
        i = 0
        for r in range(self.rows):
            for c in range(self.cols):
                block = np.zeros((H, W), bool)
                block[r * hs : (r + 1) * hs, c * ws : (c + 1) * ws] = True
                block &= depth > 1e-6
                regions[i] = block
                rr, cc = np.nonzero(block)
                if rr.size:
                    k = rr.size // 2
                    kp_rc[i] = [rr[k], cc[k]]
                i += 1
        good = regions.reshape(N, -1).any(axis=1)
        regions, kp_rc = regions[good], kp_rc[good]
        safe_depth = np.where(depth > 1e-6, depth, 1.0)
        logdepth = np.log(safe_depth)[None] * regions
        return {
            "image": img,
            "K": np.asarray(K, np.float32),
            "regions": regions,
            "logdepth_perseg": logdepth.astype(np.float32),
            "keypoints_rc": kp_rc,
        }

    def process_to_supp_kf(self, image: np.ndarray, K: np.ndarray) -> dict:
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        img, K = self._downsample(img, K)
        return {"image": img, "K": np.asarray(K, np.float32)}

    def observe(self, frame: dict):
        """Driver hook: capture the frame's GT depth before process_to_kf
        (the reference frontend infers geometry from the image alone; this
        stub substitutes GT depth for the predicted+integrated geometry)."""
        self._depth = np.asarray(frame["depth"], np.float32)


class PatchSegmentFrontend:
    """Depth-completion stub: one square segment of ``patch`` pixels a side
    around each query keypoint, its frozen log-depth taken from a GT depth
    map, so the completion (median alignment, overlap averaging, the loose
    rerun, the metrics) runs end to end without the nets.  A ``loose`` call
    doubles the patch.  ``calls`` records each call's ``loose``.  The
    segments are host arrays; ``device`` is where the completion that
    consumes them forms its dense depths.

    GT depth comes from the constructor or per sample through
    ``observe(sample)``, which reads ``sample["gt_depth"]`` (non-finite
    values as 0)."""

    def __init__(self, gt_depth=None, patch: int = 9,
                 device: str | torch.device = "cuda"):
        self.gt = None if gt_depth is None else np.asarray(gt_depth, np.float32)
        self.patch = patch
        self.device = torch.device(device)
        self.calls: list[bool] = []

    def observe(self, sample: dict):
        gt = np.asarray(sample["gt_depth"], np.float32)
        self.gt = np.where(np.isfinite(gt), gt, 0.0)

    def process_to_kf(self, image, K, keypoints=None, loose=False) -> dict:
        if self.gt is None:
            raise RuntimeError("set gt_depth or call observe(sample) first")
        self.calls.append(loose)
        H, W = self.gt.shape
        dims = np.asarray([H, W], np.float32)
        kp_rc = np.round(0.5 * (dims - 1) * (keypoints + 1)).astype(np.int64)
        p = self.patch * (2 if loose else 1)
        N = kp_rc.shape[0]
        regions = np.zeros((N, H, W), bool)
        for i, (r, c) in enumerate(kp_rc):
            r0, r1 = max(0, r - p // 2), min(H, r + p // 2 + 1)
            c0, c1 = max(0, c - p // 2), min(W, c + p // 2 + 1)
            regions[i, r0:r1, c0:c1] = True
        logdepth = np.log(np.maximum(self.gt, 1e-6))[None] * regions
        return {
            "image": np.asarray(image, np.float32),
            "K": np.asarray(K, np.float32),
            "regions": regions,
            "logdepth_perseg": logdepth.astype(np.float32),
            "keypoints_rc": kp_rc,
        }
