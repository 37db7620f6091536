"""Segment post-processing: the depth-discontinuity split.

Port of ``super_primitive_tpu/frontend/post_process.py``
(``depth_discontinuity`` and ``split_disconnected_segments``): detect depth
discontinuities per segment (max-pool the depth, then a Scharr-gradient
threshold), erase those pixels, split what remains of every segment into
4-connected components, keep the parts above an area ratio, and re-seed
one keypoint per part from the caller's generator.

The discontinuities and the labels are computed on full-frame (N, H, W)
stacks on the frontend's device, :data:`SPLIT_CHUNK_PIXELS` segment pixels
at a time (each segment's result depends on its own mask alone); the JAX
package computes them on bbox crops, which gives the same pixels.  Parts
come in ascending label order,
and labels are row-major minimum indices, so a full-frame labelling and a
crop labelling order the parts alike and the generator draws the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..image.gradients import scharr_gradients
from ..ops.connected_components import label_components
from ..utils import timing
from ..utils.numerics import sqrt_rn

# segment pixels a device pass of the split takes: 436 segments at
# 480x640, whose int64 labels and their scans hold about 8 GB (VOID's
# loose rerun gives thousands of segments at that size)
SPLIT_CHUNK_PIXELS = 2**27


def depth_discontinuity(logdepth: torch.Tensor, validity: torch.Tensor,
                        filter_size: int = 3, threshold: float = 0.1) -> torch.Tensor:
    """(N, H, W) bool: exp -> invalid = -1 -> stride-1 max pool (padding
    never wins) -> Scharr magnitude > threshold, on valid pixels."""
    depth = torch.where(validity, torch.exp(logdepth), torch.full_like(logdepth, -1.0))
    pad = filter_size // 2
    pooled = F.max_pool2d(depth[:, None], filter_size, stride=1, padding=pad)[:, 0]
    gx, gy = scharr_gradients(pooled.permute(1, 2, 0))
    grad = sqrt_rn(gx * gx + gy * gy).permute(2, 0, 1)
    return (grad > threshold) & validity


def split_disconnected_segments(
    regions: np.ndarray,
    logdepth_perseg: np.ndarray,
    keypoints_rc: np.ndarray,
    filter_size: int = 3,
    depth_threshold: float = 0.1,
    area_keep_ratio: float = 1e-3,
    rng: np.random.Generator | None = None,
    device: str | torch.device = "cuda",
    timer=None,
):
    """Split every segment at its depth discontinuities and into its
    connected parts (the reference's kf_fix_disconnected_regions).

    Returns new (regions, logdepth_perseg, keypoints_rc).  A part's keypoint
    is a random pixel of the part; a segment that stays in one part keeps
    its mask and keypoint; parts of at most ``area_keep_ratio * H * W``
    pixels are dropped.  Every segment is labelled, not only those with
    discontinuities: a SAM mask can be disconnected by itself."""
    rng = rng or np.random.default_rng(0)
    N, H, W = regions.shape
    if N == 0:
        return regions, logdepth_perseg, keypoints_rc
    min_px = area_keep_ratio * (H * W)
    labels = np.empty((N, H * W), np.int32)
    n_kept = np.empty(N, np.int64)
    several = {}  # segment -> its kept labels, for segments with more than one
    step = max(1, SPLIT_CHUNK_PIXELS // (H * W))
    for lo in range(0, N, step):
        with timing.span(timer, "split_disc"):
            reg_t = torch.from_numpy(np.ascontiguousarray(regions[lo:lo + step], bool)).to(device)
            ld_t = torch.from_numpy(
                np.ascontiguousarray(logdepth_perseg[lo:lo + step], np.float32)).to(device)
            disc = depth_discontinuity(ld_t, reg_t, filter_size, depth_threshold)
        with timing.span(timer, "split_cc"):
            lab = label_components(reg_t & ~disc).reshape(-1, H * W)
            labels[lo:lo + step] = timing.to_host(lab)
        with timing.span(timer, "split_parts"):
            # each part's pixel count, at its label (a linear index)
            sizes = torch.zeros(lab.shape, dtype=torch.int32, device=lab.device)
            sizes.scatter_add_(1, lab.clamp(min=0).long(), (lab >= 0).to(torch.int32))
            kept = sizes > min_px
            counts = kept.sum(dim=1)
            n_kept[lo:lo + step] = timing.to_host(counts)
            for j in np.flatnonzero(n_kept[lo:lo + step] > 1).tolist():
                several[lo + j] = np.flatnonzero(timing.to_host(kept[j]))

    with timing.span(timer, "split_parts"):
        # (segment i, None = kept whole, else its kept labels)
        parts = [(i, several.get(i)) for i in range(N) if n_kept[i] > 0]
        n_out = sum(1 if k is None else len(k) for _, k in parts)
        if n_out == 0 or (n_out == N and all(k is None for _, k in parts)):
            return regions, logdepth_perseg, keypoints_rc
        out_masks = np.zeros((n_out, H, W), bool)
        out_kp = np.zeros((n_out, 2), keypoints_rc.dtype)
        src_idx = np.zeros(n_out, np.int64)
        j = 0
        for i, kept_ids in parts:
            if kept_ids is None:
                out_masks[j] = regions[i]
                out_kp[j] = keypoints_rc[i]
                src_idx[j] = i
                j += 1
                continue
            lab = labels[i].reshape(H, W)
            for cid in kept_ids:
                part = lab == cid
                out_masks[j] = part
                rr, cc = np.nonzero(part)
                k = rng.integers(0, rr.size)
                out_kp[j] = [rr[k], cc[k]]
                src_idx[j] = i
                j += 1
    return out_masks, np.take(logdepth_perseg, src_idx, axis=0), out_kp
