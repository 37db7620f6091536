"""Plain reference of SAM's mask selection as the frontend runs it: the
full-resolution stability and area of every candidate, the smallest good
mask of each prompt, its bit-packed mask and box, greedy box NMS, and the
coverage-driven second round of prompts.

Frozen copy, at commit 51882e36a88e, of
``super_primitive_tpu_torch/ops/phase_counts.phase_counts_reference`` (the
plain version of kernel K3), ``nets/sam/predictor.py``'s
``select_from_lowres``, ``_select_nms_device`` and ``select_finish``, and
``frontend/mask_generation.py``'s ``active_sample_pos`` and two-round
device selection path.  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_THRESHOLD = 0.0
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def phase_counts(x: torch.Tensor, s: int, input_hw: tuple[int, int]):
    """(hi, lo, area) (N,) int32: the pixels of the half-pixel bilinear x s
    upsample of x (N, S, S) above +1, -1 and 0 inside the region
    ``s*i + k < input_hw``."""
    h_in, w_in = int(input_hw[0]), int(input_hw[1])
    S = x.shape[-1]
    xm_r = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    xp_r = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    idx = torch.arange(S, device=x.device)
    hi = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    lo = torch.zeros_like(hi)
    area = torch.zeros_like(hi)
    for ky in range(s):
        f = (ky + 0.5) / s - 0.5
        ry = (1 + f) * x - f * xm_r if f < 0 else (1 - f) * x + f * xp_r
        rym = torch.cat([ry[:, :, :1], ry[:, :, :-1]], dim=2)
        ryp = torch.cat([ry[:, :, 1:], ry[:, :, -1:]], dim=2)
        rok = (s * idx + ky) < h_in
        for kx in range(s):
            g = (kx + 0.5) / s - 0.5
            v = (1 + g) * ry - g * rym if g < 0 else (1 - g) * ry + g * ryp
            reg = rok[:, None] & ((s * idx + kx) < w_in)[None, :]
            hi += torch.sum((v > MASK_THRESHOLD + 1.0) & reg, dim=(1, 2), dtype=torch.int32)
            lo += torch.sum((v > MASK_THRESHOLD - 1.0) & reg, dim=(1, 2), dtype=torch.int32)
            area += torch.sum((v > MASK_THRESHOLD) & reg, dim=(1, 2), dtype=torch.int32)
    return hi, lo, area


def packbits(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., W//8) uint8, MSB first."""
    W = masks.shape[-1]
    b = masks.reshape(*masks.shape[:-1], W // 8, 8).to(torch.int32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=masks.device)
    return torch.sum(b * w, dim=-1).to(torch.uint8)


def unpackbits(packed: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(torch.bool)


def _region(out_size: int, input_hw, target_length: int, device) -> torch.Tensor:
    scale = target_length / out_size
    c = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale
    return (c <= input_hw[0])[:, None] & (c <= input_hw[1])[None, :]


def _first_last(a: torch.Tensor):
    a = a.to(torch.int32)
    first = torch.argmax(a, dim=1)
    last = a.shape[1] - 1 - torch.argmax(a.flip(1), dim=1)
    return first, last


def pick_round(lowres, iou, input_hw, target_length: int, stab_thr: float, iou_thr: float):
    """Each prompt's smallest good candidate from (B, 3, S, S) low-res
    logits and (B, 3) IoU predictions: (pick (B,), valid (B,)), a prompt
    valid where some candidate passes the thresholds."""
    B, M, S = lowres.shape[0], lowres.shape[1], lowres.shape[-1]
    hi, lo, areas = phase_counts(lowres.reshape(B * M, S, S).contiguous(),
                                 target_length // S, input_hw)
    stability = (hi.to(torch.float32) / torch.clamp(lo, min=1).to(torch.float32)).reshape(B, M)
    areas = areas.reshape(B, M)
    good = torch.ones((B, M), dtype=torch.bool, device=lowres.device)
    if iou_thr > 0:
        good = good & (iou > iou_thr)
    if stab_thr > 0:
        good = good & (stability >= stab_thr)
    valid = good.any(dim=1)
    sizes = torch.where(good, areas.to(torch.float32), torch.full_like(stability, 1e6))
    return torch.argmin(sizes, dim=1), valid


def select_round(lowres, iou, input_hw, target_length: int, stab_thr: float, iou_thr: float):
    """The smallest-good pick from (B, 3, S, S) low-res logits and (B, 3)
    IoU predictions: (packed masks (B, S, S/8), picked IoU (B,), valid (B,),
    xyxy boxes (B, 4) on the S grid)."""
    B, S = lowres.shape[0], lowres.shape[-1]
    pick, valid = pick_round(lowres, iou, input_hw, target_length, stab_thr, iou_thr)
    ar = torch.arange(B, device=lowres.device)
    picked, iou_pick = lowres[ar, pick], iou[ar, pick]
    masks_bin = (picked > MASK_THRESHOLD) & _region(S, input_hw, target_length, picked.device)
    any_r, any_c = masks_bin.any(dim=2), masks_bin.any(dim=1)
    r0, r1 = _first_last(any_r)
    c0, c1 = _first_last(any_c)
    boxes = torch.stack([c0, r0, c1 + 1, r1 + 1], dim=1).to(torch.float32)
    boxes = torch.where(any_r.any(dim=1)[:, None], boxes, torch.zeros_like(boxes))
    return packbits(masks_bin), iou_pick, valid, boxes


def nms_keep(iou_pick, valid, boxes, thr: float, by_size: bool) -> np.ndarray:
    """Greedy box NMS (descending score, stable ties, suppress IoU > thr)
    over the valid rows: the kept rows in score order."""
    C = boxes.shape[0]
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    scores = 1.0 / torch.clamp(area, min=1e-9) if by_size else iou_pick
    scores = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-scores, stable=True).cpu().numpy()
    tl = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    br = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    inter = torch.prod(torch.clamp(br - tl, min=0), dim=-1)
    ious = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    over = (ious > thr).cpu().numpy()
    valid_h = valid.cpu().numpy()
    kept, sup = np.zeros(C, bool), np.zeros(C, bool)
    for i in order:
        if valid_h[i] and not sup[i]:
            kept[i] = True
            sup |= over[i]
        sup[i] = True
    return order[kept[order]]


def active_sample_pos(coverage: np.ndarray, num_samples: int, rng: np.random.Generator):
    """Categorical resampling of the uncovered 16x-pooled cells with
    in-cell jitter: (num_samples, 2) normalised (row, col) prompts."""
    H, W = coverage.shape
    down = 16
    cm = coverage.copy()
    cm[-2:, :] = True
    Hc, Wc = H // down, W // down
    coarse = cm[: Hc * down, : Wc * down].reshape(Hc, down, Wc, down).mean(axis=(1, 3))
    density = 1.0 - coarse
    if density.sum() < 1e-9:
        density = np.ones_like(density)
    p = density.ravel() / density.sum()
    flat = rng.choice(Hc * Wc, size=num_samples, p=p)
    cell_rc = np.stack([flat // Wc, flat % Wc], axis=1).astype(np.float32)
    norm = 2 * cell_rc / (np.asarray([Hc, Wc], np.float32) - 1) - 1
    dims = np.asarray([H, W], np.float32)
    jitter_px = rng.integers(0, down // 2, size=(num_samples, 2)).astype(np.float32)
    jitter = (2 * jitter_px / (dims - 1) - 1) + 1
    return np.clip(norm + jitter, -1, 1).astype(np.float32)


def input_xy(kps_norm: np.ndarray, input_hw) -> np.ndarray:
    """Normalised (row, col) prompts -> (x, y) pixels of the resized input
    frame, as the frontend hands them to SAM."""
    dims = np.asarray(input_hw, np.float32)
    rc = 0.5 * (dims - 1) * (np.asarray(kps_norm) + 1)
    return np.round(rc[:, ::-1]).astype(np.float32)


def select_masks(rounds, kps1: np.ndarray, num_active: int, rng: np.random.Generator,
                 image_hw, input_hw, target_length: int, sam_params: dict) -> dict:
    """The frontend's two selection rounds replayed on the decoder outputs
    ``rounds`` [(low-res logits (B, 3, S, S), IoU (B, 3)), ...] of its
    prompts: round 1's ``kps1``, round 2's drawn from ``rng`` on round 1's
    coverage (of the (hs, ws) mask grid; of the ``image_hw`` SAM image
    where round 1 kept nothing, as the frontend has it).  Returns masks
    (M, hs, ws) bool, keypoints (M, 2) and each round's prompts, (x, y)
    input-frame pixels."""
    S = rounds[0][0].shape[-1]
    hs = int(round(input_hw[0] * S / target_length))
    ws = int(round(input_hw[1] * S / target_length))

    def one(lowres, iou, kps):
        packed, iou_pick, valid, boxes = select_round(
            lowres, iou, input_hw, target_length, float(sam_params["stability_threshold"]),
            float(sam_params["iou_threshold"]))
        if sam_params["nms"] and bool(valid.any()):
            ids = nms_keep(iou_pick, valid, boxes, float(sam_params["box_nms_thresh"]),
                           bool(sam_params["filter_by_box_size"]))
        else:
            ids = np.nonzero(valid.cpu().numpy())[0]
        rows = packed[torch.as_tensor(ids, dtype=torch.int64, device=packed.device)]
        return unpackbits(rows)[:, :hs, :ws].cpu().numpy(), kps[ids]

    masks1, kf1 = one(*rounds[0], kps1)
    prompts = [input_xy(kps1, input_hw)]
    masks, kps = [masks1], [kf1]
    if num_active > 0:
        coverage = masks1.any(axis=0) if len(masks1) else np.zeros(tuple(image_hw), bool)
        kps2 = active_sample_pos(coverage, num_active, rng)
        prompts.append(input_xy(kps2, input_hw))
        masks2, kf2 = one(*rounds[1], kps2)
        masks.append(masks2)
        kps.append(kf2)
    return {"masks": np.concatenate(masks), "keypoints": np.concatenate(kps),
            "prompts": prompts, "n_round1": len(masks1)}
