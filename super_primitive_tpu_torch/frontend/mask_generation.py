"""SAM mask generation.

Port of ``super_primitive_tpu/frontend/mask_generation.py``: random query
points -> SAM multimask logits -> IoU + stability filtering with
smallest-good-mask selection -> box NMS -> coverage-driven active
resampling of uncovered 16x-pooled cells -> second SAM round -> edge maps
from mask gradients -> off-mask keypoint filtering.

The mask model is injected as ``predict(image, keypoints_norm) ->
(mask_logits (B, 3, H, W), iou (B, 3))``, whose selection and filtering
run here in numpy, or as a device predictor whose ``select_round`` does
the selection and NMS on the card (``nets/sam/predictor.py``).  The edge
maps run in PyTorch on the frontend's device.  Query points come from an explicit
``numpy.random.Generator``, so the port draws the same points as the JAX
package from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..image.gradients import scharr_gradients
from ..utils import timing

MASK_THRESH = 0.0
STABILITY_OFFSET = 1.0


def calculate_stability_score(mask_logits: np.ndarray, thresh: float, offset: float):
    """IoU between thresholded masks at (t+o) and (t-o) — the SAM stability
    score (amg semantics)."""
    hi = (mask_logits > (thresh + offset)).sum(axis=(-2, -1), dtype=np.int64)
    lo = (mask_logits > (thresh - offset)).sum(axis=(-2, -1), dtype=np.int64)
    return hi / np.maximum(lo, 1)


def mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (N, 4) xyxy boxes; empty masks give zero boxes
    (amg batched_mask_to_box semantics)."""
    N, H, W = masks.shape
    boxes = np.zeros((N, 4), np.float32)
    any_r = masks.any(axis=2)
    any_c = masks.any(axis=1)
    for i in range(N):
        rr = np.nonzero(any_r[i])[0]
        cc = np.nonzero(any_c[i])[0]
        if rr.size and cc.size:
            boxes[i] = [cc[0], rr[0], cc[-1] + 1, rr[-1] + 1]
    return boxes


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """torchvision-nms semantics: keep by descending score, suppress
    IoU > threshold.  Returns kept indices in score order."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    ious = box_iou(boxes, boxes)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= ious[i] > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def smallest_good_mask_batch(
    mask_logits: np.ndarray,
    iou_pred: np.ndarray,
    iou_threshold: float = 0.0,
    stability_score_thresh: float = 0.90,
    select_smallest: bool = True,
    stability: np.ndarray | None = None,
    areas: np.ndarray | None = None,
):
    """Reference smallest_good_mask_batch (mask_generation.py:13-95).

    select_smallest: keep keypoints with >= 1 good candidate and pick their
    smallest good binarized mask; otherwise flatten all candidates and filter
    per-candidate.

    ``stability``/``areas`` (B, 3): full-resolution statistics from a
    device predictor's statistics path; ``mask_logits`` may then be
    binarised bool masks at working resolution.

    Returns dict(masks bool (M, H, W), iou_preds (M,), keypoints_ids (M,),
    boxes (M, 4)).
    """
    B = mask_logits.shape[0]
    kp_ids = np.arange(B)

    if select_smallest:
        good = np.ones((B, 3), bool)
        if iou_threshold > 0:
            good &= iou_pred > iou_threshold
            keep_kp = good.any(axis=1)
            mask_logits, iou_pred, good, kp_ids = (
                mask_logits[keep_kp], iou_pred[keep_kp], good[keep_kp], kp_ids[keep_kp]
            )
        if stability_score_thresh > 0:
            stab = (stability[kp_ids] if stability is not None else
                    calculate_stability_score(mask_logits, MASK_THRESH, STABILITY_OFFSET))
            good &= stab >= stability_score_thresh
            keep_kp = good.any(axis=1)
            mask_logits, iou_pred, good, kp_ids = (
                mask_logits[keep_kp], iou_pred[keep_kp], good[keep_kp], kp_ids[keep_kp]
            )
        masks_bin = mask_logits if mask_logits.dtype == bool else mask_logits > MASK_THRESH
        if areas is not None:
            sizes = areas[kp_ids].astype(np.float64)
        else:
            sizes = masks_bin.sum(axis=(-2, -1)).astype(np.float64)
        sizes[~good] = 1e6
        pick = sizes.argmin(axis=1)
        ar = np.arange(masks_bin.shape[0])
        masks = masks_bin[ar, pick]
        ious = iou_pred[ar, pick]
        result = {
            "masks": masks, "iou_preds": ious, "keypoints_ids": kp_ids,
            "masks_ids": pick,
        }
    else:
        flat_logits = mask_logits.reshape(-1, *mask_logits.shape[2:])
        flat_iou = iou_pred.reshape(-1)
        flat_kp = np.repeat(kp_ids, 3)
        keep = np.ones(len(flat_iou), bool)
        if iou_threshold > 0:
            keep &= flat_iou > iou_threshold
        if stability_score_thresh > 0:
            stab = (stability.reshape(-1) if stability is not None else
                    calculate_stability_score(flat_logits, MASK_THRESH, STABILITY_OFFSET))
            keep &= stab >= stability_score_thresh
        kept = flat_logits[keep]
        result = {
            "masks": kept if kept.dtype == bool else kept > MASK_THRESH,
            "iou_preds": flat_iou[keep],
            "keypoints_ids": flat_kp[keep],
        }
    result["boxes"] = mask_to_box(result["masks"])
    return result


def active_sample_pos(
    coverage_mask: np.ndarray, num_samples: int, rng: np.random.Generator,
):
    """Categorical resampling of uncovered 16x-pooled cells + in-cell jitter
    (mask_generation.py:98-139).  coverage_mask (H, W) bool; returns
    normalized (row, col) keypoints (num_samples, 2)."""
    H, W = coverage_mask.shape
    down = 16
    cm = coverage_mask.copy()
    cm[-2:, :] = True  # SAM bottom-row artifact compensation (:105)
    Hc, Wc = H // down, W // down
    coarse = cm[: Hc * down, : Wc * down].reshape(Hc, down, Wc, down).mean(axis=(1, 3))
    density = 1.0 - coarse
    if density.sum() < 1e-9:
        # fully covered: fall back to uniform (the reference's Categorical
        # would fault here; coverage is never complete on real images)
        density = np.ones_like(density)
    p = density.ravel() / density.sum()

    flat = rng.choice(Hc * Wc, size=num_samples, p=p)
    cell_rc = np.stack([flat // Wc, flat % Wc], axis=1).astype(np.float32)
    dims_c = np.asarray([Hc, Wc], np.float32)
    norm = 2 * cell_rc / (dims_c - 1) - 1
    dims = np.asarray([H, W], np.float32)
    jitter_px = rng.integers(0, down // 2, size=(num_samples, 2)).astype(np.float32)
    jitter = (2 * jitter_px / (dims - 1) - 1) + 1
    return np.clip(norm + jitter, -1, 1).astype(np.float32)


def _edges(f: torch.Tensor) -> np.ndarray:
    """Max Scharr magnitude over (N, H, W) float32 masks on their device,
    reflect-padded Scharr/32; the (H, W) map on the host."""
    gx, gy = scharr_gradients(f.permute(1, 2, 0), reflect_padding=True)
    return timing.to_host(torch.amax(torch.sqrt(gx**2 + gy**2), dim=-1))


def masks_to_edges(masks: np.ndarray, device: str | torch.device = "cuda") -> np.ndarray:
    """Max Scharr magnitude over (N, H, W) masks, reflect-padded Scharr/32,
    computed on ``device``; returns the (H, W) float32 map on the host."""
    return _edges(torch.from_numpy(np.ascontiguousarray(masks, dtype=np.float32)).to(device))


def infer_edge_probs(masks: np.ndarray, device: str | torch.device = "cuda"):
    edges = masks_to_edges(masks, device)
    return edges, np.clip(1 - 2 * edges, 0, 1)


def bilinear_resize_ac(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W) bilinear resize with align_corners=True (torch semantics)."""
    Ho, Wo = hw
    Hi, Wi = img.shape
    ry = np.arange(Ho) * ((Hi - 1) / (Ho - 1) if Ho > 1 else 0.0)
    rx = np.arange(Wo) * ((Wi - 1) / (Wo - 1) if Wo > 1 else 0.0)
    y0 = np.clip(np.floor(ry).astype(np.int64), 0, Hi - 1)
    x0 = np.clip(np.floor(rx).astype(np.int64), 0, Wi - 1)
    y1 = np.minimum(y0 + 1, Hi - 1)
    x1 = np.minimum(x0 + 1, Wi - 1)
    wy = (ry - y0).astype(img.dtype if img.dtype.kind == "f" else np.float32)
    wx = (rx - x0).astype(wy.dtype)
    top = img[y0[:, None], x0[None, :]] * (1 - wx) + img[y0[:, None], x1[None, :]] * wx
    bot = img[y1[:, None], x0[None, :]] * (1 - wx) + img[y1[:, None], x1[None, :]] * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


def infer_edge_probs_coarse(
    masks: np.ndarray, edge_probs_shape: tuple[int, int],
    device: str | torch.device = "cuda",
):
    """Coarse-edge path (reference mask_generation.py:234-252): nearest-
    downsample masks to ``edge_probs_shape``, compute edges there, bilinearly
    upsample (align_corners=True) back to the mask working resolution.

    Returns (edges, edge_probs, edges_coarse, edge_probs_coarse)."""
    H, W = masks.shape[-2:]
    Ho, Wo = edge_probs_shape
    # nearest resize with torch F.interpolate(mode='nearest') indices,
    # src = floor(dst * H_in / H_out), on the device (the masks go up as
    # bool; depth completion's loose rerun has thousands)
    ri = torch.from_numpy((np.arange(Ho) * H) // Ho).to(device)
    ci = torch.from_numpy((np.arange(Wo) * W) // Wo).to(device)
    m = torch.from_numpy(np.ascontiguousarray(masks, dtype=bool)).to(device)
    edges_coarse = _edges(m[:, ri][:, :, ci].to(torch.float32))
    probs_coarse = np.clip(1 - 2 * edges_coarse, 0, 1)
    edges = bilinear_resize_ac(edges_coarse, (H, W))
    probs = bilinear_resize_ac(probs_coarse, (H, W))
    return edges, probs, edges_coarse, probs_coarse


def infer_masks(
    predict_fn,
    image: np.ndarray,
    sam_params,
    keypoints: np.ndarray | None = None,
    num_pts: int = 300,
    num_pts_active: int = 100,
    rng: np.random.Generator | None = None,
    edge_probs_shape: tuple[int, int] | None = None,
    device: str | torch.device = "cuda",
    on_round1=None,
    timer=None,
):
    """Two-round mask generation.

    ``predict_fn(image, keypoints_norm) -> (logits (B, 3, H, W), iou (B, 3))``
    (or, from a device predictor's statistics path, ``(masks, iou,
    stability, areas)``).  A ``predict_fn.select_round`` with ``dispatch``
    and ``finish`` (``process_frame.wire_mask_predictor``) takes the device
    selection path instead: round 1's survivors stay packed on the device,
    coverage for the active resampling is OR-reduced there, and the host
    masks come over after round 2 is dispatched.  Both paths give the same
    output.

    Returns a dict with masks, keypoints (normalized row-col), coverage,
    edges and each mask's provenance (``src_round`` 0/1 and ``src_idx``, its
    row in that round's selection).  ``edge_probs_shape``: when set, edges
    are computed on masks nearest-downsampled to this shape and bilinearly
    upsampled back.  ``on_round1(masks)`` is called with round 1's
    selection (a ``DeferredMasks`` on the device path) before round 2, so a
    caller can start per-segment work early.  ``timer``: an optional
    ``utils.timing.StageTimer`` for the sam_round1 / sam_round2 / sam_edges
    stages.  Counts each round's ``prompts_decoded`` as it is dispatched
    and its ``masks_kept`` after the selection and NMS."""
    rng = rng or np.random.default_rng(42)
    H, W = image.shape[:2]
    if keypoints is None:
        keypoints = (rng.random((num_pts, 2)) * 2 - 1).astype(np.float32)

    def run_round(kps):
        timing.count("prompts_decoded", len(kps))
        out = predict_fn(image, kps)
        stability = areas = None
        if len(out) == 4:  # device statistics path
            logits, iou, stability, areas = out
        else:
            logits, iou = out
        sel = smallest_good_mask_batch(
            np.asarray(logits), np.asarray(iou),
            iou_threshold=sam_params.iou_threshold,
            stability_score_thresh=sam_params.stability_threshold,
            select_smallest=sam_params.select_smallest,
            stability=stability, areas=areas,
        )
        kps_f = kps[sel["keypoints_ids"]]
        if sam_params.nms:
            area = np.prod(sel["boxes"][:, 2:] - sel["boxes"][:, :2], axis=-1)
            scores = (
                1.0 / np.maximum(area, 1e-9)
                if sam_params.filter_by_box_size
                else sel["iou_preds"]
            )
            keep = nms(sel["boxes"], scores, sam_params.box_nms_thresh)
            sel = {k: v[keep] for k, v in sel.items()}
            kps_f = kps_f[keep]
        timing.count("masks_kept", len(kps_f))
        return sel, kps_f

    sr = getattr(predict_fn, "select_round", None)
    if sr is not None and sam_params.select_smallest:
        with timing.span(timer, "sam_round1"):
            timing.count("prompts_decoded", len(keypoints))
            h1 = sr.dispatch(image, keypoints, sam_params)
            sel = sr.finish(h1, sam_params, defer_masks=True)
            deferred = sel.pop("deferred")
            cov_pre = sel.pop("coverage", None)
            kps_f = keypoints[sel["keypoints_ids"]]
            timing.count("masks_kept", len(kps_f))
        n1 = deferred.n_rows
        if n1:
            H, W = deferred.hs, deferred.ws  # mask working resolution
            coverage = cov_pre if cov_pre is not None else deferred.coverage()
        else:
            coverage = np.zeros((H, W), bool)
        if on_round1 is not None:
            on_round1(deferred if n1 else np.zeros((0, H, W), bool))
        sel2 = None
        if num_pts_active > 0:
            kps_active = active_sample_pos(coverage, num_pts_active, rng)
            with timing.span(timer, "sam_round2"):
                timing.count("prompts_decoded", len(kps_active))
                h2 = sr.dispatch(image, kps_active, sam_params)
                sel["masks"] = deferred.fetch()
                sel2 = sr.finish(h2, sam_params)
                kps2_f = kps_active[sel2["keypoints_ids"]]
                timing.count("masks_kept", len(kps2_f))
        else:
            sel["masks"] = deferred.fetch()
    else:
        with timing.span(timer, "sam_round1"):
            sel, kps_f = run_round(keypoints)
        if len(sel["masks"]):
            H, W = sel["masks"].shape[-2:]  # mask working resolution
            coverage = sel["masks"].any(axis=0)
        else:
            coverage = np.zeros((H, W), bool)
        n1 = len(sel["masks"])
        if on_round1 is not None:
            on_round1(sel["masks"])
        sel2 = None
        if num_pts_active > 0:
            kps_active = active_sample_pos(coverage, num_pts_active, rng)
            with timing.span(timer, "sam_round2"):
                sel2, kps2_f = run_round(kps_active)

    sel["src_round"] = np.zeros(n1, np.int64)
    sel["src_idx"] = np.arange(n1)
    num_added = 0
    if sel2 is not None:
        num_added = len(kps2_f)
        sel = {
            "masks": np.concatenate([sel["masks"], sel2["masks"]], axis=0),
            "iou_preds": np.concatenate([sel["iou_preds"], sel2["iou_preds"]]),
            "boxes": np.concatenate([sel["boxes"], sel2["boxes"]], axis=0),
            "src_round": np.concatenate([sel["src_round"], np.ones(num_added, np.int64)]),
            "src_idx": np.concatenate([sel["src_idx"], np.arange(num_added)]),
        }
        kps_f = np.concatenate([kps_f, kps2_f], axis=0)

    with timing.span(timer, "sam_edges"):
        if not len(sel["masks"]):
            edges = edges_coarse = np.zeros((H, W), np.float32)
            edge_probs = edge_probs_coarse = np.ones((H, W), np.float32)
        elif edge_probs_shape is None:
            edges, edge_probs = infer_edge_probs(sel["masks"], device)
            edges_coarse, edge_probs_coarse = edges, edge_probs
        else:
            edges, edge_probs, edges_coarse, edge_probs_coarse = infer_edge_probs_coarse(
                sel["masks"], tuple(edge_probs_shape), device
            )

    if sam_params.cut_masks_by_edges and len(sel["masks"]):
        valid = edge_probs > sam_params.edge_probs_threshold
        sel["masks"] = sel["masks"] & valid[None]

    if sam_params.filter_edge_points and len(sel["masks"]):
        dims = np.asarray([H, W], np.float32)
        kp_px = np.round(0.5 * (dims - 1) * (kps_f + 1)).astype(np.int64)
        on_mask = sel["masks"][np.arange(len(kps_f)), kp_px[:, 0], kp_px[:, 1]]
        sel = {k: v[on_mask] for k, v in sel.items()}
        kps_f = kps_f[on_mask]

    final_coverage = (
        sel["masks"].any(axis=0) if len(sel["masks"]) else np.zeros((H, W), bool)
    )
    return {
        "masks": sel["masks"],
        "iou_preds": sel["iou_preds"],
        "keypoints": kps_f,
        "src_round": sel["src_round"],
        "src_idx": sel["src_idx"],
        "num_active": num_added,
        "coarse_coverage": coverage,
        "final_coverage": final_coverage,
        "edges": edges,
        "edge_probs": edge_probs,
        "edge_coarse": edges_coarse,
        "edge_probs_coarse": edge_probs_coarse,
    }
