"""Plain reference of the keyframe's last steps and of depth completion's
first pass: per-segment depths to the keyframe's size, keypoints snapped
into their regions, the depth-discontinuity split into connected parts,
and the median-shift alignment to sparse depth with the overlap average.

Frozen copy, at commit 51882e36a88e, of the arithmetic of
``super_primitive_tpu_torch/frontend/process_frame.py`` (steps 4 and 5),
``keyframe.put_keypoints_back``, ``frontend/post_process.py``,
``image/gradients.scharr_gradients``, ``odometry/depth_init.py`` and
``depth_completion/completion.py``.  Two parts are written anew rather
than copied: the nearest in-region pixel is found by a full search, and
the connected parts are scipy's 4-connected labels (numbered in raster
order of their first pixel, the order of the program's minimum-index
labels).  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from .resize import nn_resize


def _nearest_pixel(mask: np.ndarray, r: int, c: int) -> tuple[int, int]:
    rr, cc = np.nonzero(mask)
    j = int(np.argmin((rr - r) ** 2 + (cc - c) ** 2))  # first of the nearest, row-major
    return int(rr[j]), int(cc[j])


def put_keypoints_back(keypoints, regions, logdepth):
    """Drop empty segments; move each keypoint off its region to the
    nearest region pixel."""
    N, H, W = regions.shape
    dims = np.asarray([H, W], np.float32)
    kp = np.round(0.5 * (dims - 1.0) * (keypoints + 1.0)).astype(np.int64)
    good = regions.reshape(N, -1).sum(axis=1) > 0
    kp, regions, logdepth = kp[good], regions[good], logdepth[good]
    for i in range(len(kp)):
        if not regions[i, kp[i, 0], kp[i, 1]]:
            kp[i] = _nearest_pixel(regions[i], int(kp[i, 0]), int(kp[i, 1]))
    return (2.0 * kp / (dims - 1.0) - 1.0).astype(np.float32), regions, logdepth


def _scharr(image):
    """(gx, gy) of an (H, W, C) image, Scharr/32 with reflect padding, as
    shifted adds in the program's order."""
    p = F.pad(image.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="reflect")[0].permute(1, 2, 0)
    H, W, _ = image.shape

    def s(dy, dx):
        return p[dy:dy + H, dx:dx + W]

    inv32 = 1.0 / 32.0
    gx = (-3.0 * s(0, 0) + 3.0 * s(0, 2) - 10.0 * s(1, 0) + 10.0 * s(1, 2)
          - 3.0 * s(2, 0) + 3.0 * s(2, 2)) * inv32
    gy = (-3.0 * s(0, 0) - 10.0 * s(0, 1) - 3.0 * s(0, 2)
          + 3.0 * s(2, 0) + 10.0 * s(2, 1) + 3.0 * s(2, 2)) * inv32
    return gx, gy


def discontinuities(logdepth, validity, filter_size: int, threshold: float):
    """(N, H, W) bool: exp, -1 outside, max pool, Scharr magnitude over the
    threshold, on valid pixels."""
    depth = torch.where(validity, torch.exp(logdepth), torch.full_like(logdepth, -1.0))
    pooled = F.max_pool2d(depth[:, None], filter_size, stride=1, padding=filter_size // 2)[:, 0]
    gx, gy = _scharr(pooled.permute(1, 2, 0))
    grad = torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(gx.dtype).permute(2, 0, 1)
    return (grad > threshold) & validity


def split(regions, logdepth, kp_rc, dp: dict, rng: np.random.Generator, device):
    """Every segment split at its depth discontinuities into its
    4-connected parts; parts of at most ``area_keep_ratio * H * W`` pixels
    dropped, a part's keypoint a random pixel of it."""
    N, H, W = regions.shape
    if N == 0:
        return regions, logdepth, kp_rc
    min_px = dp["area_keep_ratio"] * (H * W)
    reg_t = torch.from_numpy(np.ascontiguousarray(regions)).to(device)
    ld_t = torch.from_numpy(np.ascontiguousarray(logdepth, np.float32)).to(device)
    disc = discontinuities(ld_t, reg_t, dp["filter_size"], dp["depth_threshold"])
    keep = (reg_t & ~disc).cpu().numpy()
    parts = []  # (segment, None = kept whole, else its parts' masks)
    for i in range(N):
        lab, n = ndimage.label(keep[i])
        sizes = np.bincount(lab.reshape(-1), minlength=n + 1)[1:]
        kept = np.nonzero(sizes > min_px)[0] + 1
        if len(kept) == 1:
            parts.append((i, None))
        elif len(kept) > 1:
            parts.append((i, [lab == k for k in kept]))
    n_out = sum(1 if p is None else len(p) for _, p in parts)
    if n_out == 0 or (n_out == N and all(p is None for _, p in parts)):
        return regions, logdepth, kp_rc
    out_masks = np.zeros((n_out, H, W), bool)
    out_kp = np.zeros((n_out, 2), kp_rc.dtype)
    src = np.zeros(n_out, np.int64)
    j = 0
    for i, p in parts:
        for part in ([regions[i]] if p is None else p):
            out_masks[j] = part
            if p is None:
                out_kp[j] = kp_rc[i]
            else:
                rr, cc = np.nonzero(part)
                k = rng.integers(0, rr.size)
                out_kp[j] = [rr[k], cc[k]]
            src[j] = i
            j += 1
    return out_masks, np.take(logdepth, src, axis=0), out_kp


def keyframe(depth_perseg, keypoints, frontend: dict, image_hw, rng, device) -> dict:
    """The keyframe's regions, log-depths and keypoint pixels from the
    per-segment depths (M, Hg, Wg) and the selection's keypoints."""
    H, W = image_hw
    s = 2 ** frontend["downsample_pow"]
    H_kf, W_kf = H // s, W // s
    depth_kf = nn_resize(depth_perseg, (H_kf, W_kf))
    regions = depth_kf > 1e-7
    kps, regions, depth_kf = put_keypoints_back(keypoints, regions, depth_kf)
    logdepth = np.zeros(depth_kf.shape, np.float32)
    np.log(depth_kf, out=logdepth, where=regions)
    dims = np.asarray([H_kf, W_kf], np.float32)
    kp_rc = np.round(0.5 * (dims - 1) * (kps + 1)).astype(np.int64)
    if frontend["check_for_depth_disc"]:
        regions, logdepth, kp_rc = split(regions, logdepth, kp_rc,
                                         frontend["depth_disc_params"], rng, device)
    return {"regions": regions, "logdepth_perseg": logdepth, "keypoints_rc": kp_rc}


def _lower_median(x):
    s = np.sort(x.reshape(-1))
    return float(s[(s.size - 1) // 2])


def complete(sparse, regions, logdepth, kp_rc, device):
    """Depth completion's first pass on a keyframe: each segment shifted by
    its median log-depth offset to the sparse depth, the visible segments'
    depths averaged where they overlap.  (depth (H, W), invalid (H, W))."""
    eps = 1e-6
    est = np.asarray(sparse, np.float32).copy()
    valid = est >= eps
    est[~valid] = eps
    est_log = np.log(est)
    N = regions.shape[0]
    kp_base = logdepth[np.arange(N), kp_rc[:, 0], kp_rc[:, 1]]
    out = np.zeros(N, np.float32)
    pix = np.flatnonzero(valid)
    shifts = est_log.reshape(-1)[pix][None] - logdepth.reshape(N, -1)[:, pix]
    vis_px = regions.reshape(N, -1)[:, pix]
    visible = vis_px.any(axis=1)
    for i in np.nonzero(visible)[0]:
        out[i] = _lower_median(shifts[i][vis_px[i]]) + kp_base[i]
    if visible.any():
        out[~visible] = _lower_median(out[visible])
    shift = out - kp_base
    idx = np.nonzero(visible)[0]
    ld = torch.from_numpy(np.ascontiguousarray(logdepth[idx])).to(device)
    reg = torch.from_numpy(np.ascontiguousarray(regions[idx])).to(device)
    sh = torch.from_numpy(shift[idx].astype(np.float32)).to(device)
    depths = torch.where(reg, torch.exp(ld + sh[:, None, None]), torch.full_like(ld, -1.0))
    H, W = regions.shape[1:]
    if depths.shape[0] == 0:
        return np.zeros((H, W), np.float32), np.ones((H, W), bool)
    invalid = depths.amax(dim=0) < 1e-6
    d = torch.where(depths < 1e-6, torch.zeros_like(depths), depths)
    count = (d > 1e-6).sum(dim=0).to(torch.float64) + 1e-6
    dense = (d.sum(dim=0).to(torch.float64) / count).to(torch.float32)
    return dense.cpu().numpy(), invalid.cpu().numpy()

