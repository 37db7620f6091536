"""SAM prompt rounds with the selection on the device (the predictor's
selection half).

Port of the selection half of ``super_primitive_tpu/nets/sam/predictor.py``:
from (B, M, S, S) low-res mask logits and (B, M) IoU predictions, the
full-resolution stability and area of every candidate come from kernel K3
(``ops/phase_counts.py``, the phase decomposition of the bilinear
upsample), then the amg smallest-good pick, the picked masks bit-packed
MSB-first, their xyxy boxes, greedy box NMS, and the survivors left packed
on the device (:class:`DeferredMasks`) until a caller needs them.

:class:`PromptRounds` holds the four prompt-round methods.  A subclass
supplies the decode (``_decode_select`` / ``_decode_stats``) and the image
state; ``frontend/fakes.DeviceFakeSAM`` is the one this package has (the
real SAM encoder and decoder are not ported yet).

Unlike the JAX package, a round decodes all its prompts in one batch (no
padding to a fixed chunk: PyTorch compiles nothing per shape), and the
greedy NMS walks its order on the host over one fetched (C, C) overlap
matrix.  Both change no output.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import phase_counts as k3

MASK_THRESHOLD = 0.0
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def get_preprocess_shape(h: int, w: int, target_length: int) -> tuple[int, int]:
    """Longest-side resize shape (SamPredictor.transform semantics)."""
    scale = target_length / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def phase_upsample_counts(x: torch.Tensor, s: int, input_hw: tuple[int, int]):
    """(stability (N,) float32, area (N,) int32) of the thresholded bilinear
    s-upsample of x (N, S, S), counted by K3 inside the unpadded region."""
    hi, lo, area = k3.phase_counts(x.contiguous(), s, input_hw)
    return hi.to(torch.float32) / torch.clamp(lo, min=1).to(torch.float32), area


def _packbits_lastaxis(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., W//8) uint8, MSB-first (np.unpackbits order)."""
    W = masks.shape[-1]
    if W % 8:
        raise ValueError(f"last axis {W} is not a multiple of 8")
    b = masks.reshape(*masks.shape[:-1], W // 8, 8).to(torch.int32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=masks.device)
    return torch.sum(b * w, dim=-1).to(torch.uint8)


def _unpackbits_lastaxis(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_packbits_lastaxis`: (..., W8) uint8 -> (..., 8*W8) bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(torch.bool)


def _region(out_size: int, input_hw, target_length: int, device) -> torch.Tensor:
    """(out_size, out_size) bool: the out_size grid cells whose centres lie
    inside the unpadded input frame."""
    scale = target_length / out_size
    c = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale
    return (c <= input_hw[0])[:, None] & (c <= input_hw[1])[None, :]


def _first_last(a: torch.Tensor):
    a = a.to(torch.int32)
    first = torch.argmax(a, dim=1)
    last = a.shape[1] - 1 - torch.argmax(a.flip(1), dim=1)
    return first, last


def stats_from_lowres(lowres, iou, input_hw, out_size: int, target_length: int):
    """Mask statistics from (B, M, S, S) low-res logits: the bit-packed
    binary masks on the out_size grid (padding zeroed), the IoU predictions,
    and K3's full-resolution stability and area, each (B, M)."""
    B, M, S = lowres.shape[0], lowres.shape[1], lowres.shape[-1]
    if out_size != S:
        raise NotImplementedError(
            "mask statistics at out_size != S need a bilinear resize that is not "
            "ported yet (ROADMAP.md, queue 1, item 8)")
    x = lowres.reshape(B * M, S, S)
    stability, areas = phase_upsample_counts(x, target_length // S, input_hw)
    masks_bin = (x > MASK_THRESHOLD) & _region(out_size, input_hw, target_length, x.device)
    packed = _packbits_lastaxis(masks_bin)
    return (packed.reshape(B, M, out_size, out_size // 8), iou,
            stability.reshape(B, M), areas.reshape(B, M))


def select_from_lowres(lowres, iou, input_hw, out_size: int, iou_thr: float,
                       stab_thr: float, target_length: int):
    """amg smallest-good selection from (B, M, S, S) low-res logits on their
    device: per-candidate IoU and stability filter (K3 statistics), a
    keypoint is valid iff it has a good candidate, the smallest good mask by
    full-resolution area is picked.  Returns (packed picked masks (B, S,
    S/8) uint8, picked IoU (B,), valid (B,) bool, xyxy boxes (B, 4) float32
    on the out_size grid (zeros for empty masks), pick (B,))."""
    B, M, S = lowres.shape[0], lowres.shape[1], lowres.shape[-1]
    if out_size != S:
        raise NotImplementedError(
            "selection at out_size != S needs a bilinear resize that is not "
            "ported yet (ROADMAP.md, queue 1, item 8)")
    stability, areas = phase_upsample_counts(
        lowres.reshape(B * M, S, S), target_length // S, input_hw)
    stability = stability.reshape(B, M)
    areas = areas.reshape(B, M)

    good = torch.ones((B, M), dtype=torch.bool, device=lowres.device)
    if iou_thr > 0:
        good = good & (iou > iou_thr)
    if stab_thr > 0:
        good = good & (stability >= stab_thr)
    kp_valid = good.any(dim=1)
    sizes = torch.where(good, areas.to(torch.float32), torch.full_like(stability, 1e6))
    pick = torch.argmin(sizes, dim=1)
    ar = torch.arange(B, device=lowres.device)
    picked = lowres[ar, pick]
    iou_pick = iou[ar, pick]

    masks_bin = (picked > MASK_THRESHOLD) & _region(out_size, input_hw, target_length,
                                                    picked.device)
    packed = _packbits_lastaxis(masks_bin)
    any_r = masks_bin.any(dim=2)
    any_c = masks_bin.any(dim=1)
    r0, r1 = _first_last(any_r)
    c0, c1 = _first_last(any_c)
    boxes = torch.stack([c0, r0, c1 + 1, r1 + 1], dim=1).to(torch.float32)
    boxes = torch.where(any_r.any(dim=1)[:, None], boxes, torch.zeros_like(boxes))
    return packed, iou_pick, kp_valid, boxes, pick


def _or_packed_rows(packed_rows: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of (n, S, S8) packed masks -> (S, S8)."""
    return _packbits_lastaxis(_unpackbits_lastaxis(packed_rows).any(dim=0))


def _select_nms_device(packed, iou_pick, kp_valid, boxes, n_valid: int,
                       nms_thr: float, by_size: bool):
    """Greedy box NMS (torchvision semantics: descending score, stable ties,
    suppress IoU > thr) over the first ``n_valid`` rows with ``kp_valid``
    set, and the survivors' coverage.  Scores are 1/max(box area, 1e-9)
    when ``by_size`` else the picked IoU, in float32 with correctly rounded
    division.  Returns (kept (C,) bool on the host, packed (S, S8) OR of the
    kept masks on the device, score order (C,) on the host)."""
    C = boxes.shape[0]
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    scores = 1.0 / torch.clamp(area, min=1e-9) if by_size else iou_pick
    valid = kp_valid & (torch.arange(C, device=boxes.device) < n_valid)
    scores = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-scores, stable=True)
    tl = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    br = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    inter = torch.prod(torch.clamp(br - tl, min=0), dim=-1)
    ious = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    over = (ious > nms_thr).cpu().numpy()
    order_h, valid_h = order.cpu().numpy(), valid.cpu().numpy()

    kept = np.zeros(C, bool)
    sup = np.zeros(C, bool)
    for i in order_h:
        if valid_h[i] and not sup[i]:
            kept[i] = True
            sup |= over[i]
        sup[i] = True
    idx = torch.as_tensor(np.nonzero(kept)[0], device=packed.device)
    cov = (_or_packed_rows(packed[idx]) if idx.numel()
           else torch.zeros(packed.shape[1:], dtype=torch.uint8, device=packed.device))
    return kept, cov, order_h


class DeferredMasks:
    """Post-NMS survivor masks left bit-packed on the device.

    - :meth:`coverage` ORs them on the device for active resampling;
    - :meth:`device_masks_resized` gives BiNI its integration-shape masks
      without a host round trip;
    - :meth:`fetch` brings the host masks over once, when a caller needs
      them.

    Row order is the selection's ("keypoints_ids") order."""

    def __init__(self, rows: torch.Tensor, hs: int, ws: int, boxes: np.ndarray):
        self.rows = rows          # (n_rows, S, S8) uint8 on the device
        self.n_rows = rows.shape[0]
        self.hs, self.ws = hs, ws
        self.boxes = boxes        # (n_rows, 4) xyxy on the (ws, hs) grid
        self._host = None

    def coverage(self) -> np.ndarray:
        """(hs, ws) bool any-mask coverage, OR-reduced on the device."""
        if self.n_rows == 0:
            return np.zeros((self.hs, self.ws), bool)
        cov = _unpackbits_lastaxis(_or_packed_rows(self.rows))
        return cov[: self.hs, : self.ws].cpu().numpy()

    def device_masks_resized(self, out_rows: np.ndarray, Hg: int, Wg: int) -> torch.Tensor:
        """(len(out_rows), Hg, Wg) device bool masks of rows ``out_rows``, the
        (hs, ws) valid region nearest-resized (cv2 INTER_NEAREST index
        formula)."""
        ri = np.minimum(np.floor(np.arange(Hg) * (self.hs / Hg)), self.hs - 1).astype(np.int64)
        ci = np.minimum(np.floor(np.arange(Wg) * (self.ws / Wg)), self.ws - 1).astype(np.int64)
        dev = self.rows.device
        m = _unpackbits_lastaxis(self.rows[torch.as_tensor(np.asarray(out_rows), device=dev)])
        return m[:, torch.as_tensor(ri, device=dev)][:, :, torch.as_tensor(ci, device=dev)]

    def resized_bbox_sizes(self, Hg: int, Wg: int):
        """Per-row (h, w) bbox extents after the nearest resize to (Hg, Wg),
        from the selection boxes.  Exact when resizing up (the floor index
        map is then surjective)."""
        b = self.boxes
        ri = np.minimum(np.floor(np.arange(Hg) * (self.hs / Hg)), self.hs - 1)
        ci = np.minimum(np.floor(np.arange(Wg) * (self.ws / Wg)), self.ws - 1)
        h = np.searchsorted(ri, b[:, 3] - 1, "right") - np.searchsorted(ri, b[:, 1], "left")
        w = np.searchsorted(ci, b[:, 2] - 1, "right") - np.searchsorted(ci, b[:, 0], "left")
        return np.maximum(h, 0), np.maximum(w, 0)

    def fetch(self) -> np.ndarray:
        """(n_rows, hs, ws) host bool masks (cached)."""
        if self._host is None:
            m = _unpackbits_lastaxis(self.rows)[:, : self.hs, : self.ws]
            self._host = m.cpu().numpy()
        return self._host


class PromptRounds:
    """The SAM predictor's prompt-round methods over a subclass's decode.

    A subclass sets ``target_length``, ``device``, ``_input_hw`` (the resized
    input frame (h2, w2), in ``set_image``) and implements
    ``_decode_select(pts, input_hw, out_size, iou_thr, stab_thr)`` and
    ``_decode_stats(pts, input_hw, out_size)`` on (B, 2) float32 (x, y)
    prompts in input-frame pixels."""

    target_length = 1024
    device = torch.device("cpu")
    _input_hw = None

    def _grid(self, out_size: int):
        if self._input_hw is None:
            raise RuntimeError("call set_image first")
        h2, w2 = self._input_hw
        hs = int(round(h2 * out_size / self.target_length))
        ws = int(round(w2 * out_size / self.target_length))
        return (h2, w2), hs, ws

    def _points(self, points_input_frame) -> torch.Tensor:
        return torch.as_tensor(np.asarray(points_input_frame, np.float32), device=self.device)

    def predict_points_with_stats(self, points_input_frame: np.ndarray, out_size: int = 256):
        """(masks bool (B, 3, hs, ws), iou (B, 3), stability (B, 3),
        areas (B, 3)) on the host; the statistics are full-resolution K3
        counts."""
        input_hw, hs, ws = self._grid(out_size)
        packed, iou, stab, area = self._decode_stats(
            self._points(points_input_frame), input_hw, out_size)
        bits = _unpackbits_lastaxis(packed)[..., :hs, :ws]
        return (bits.cpu().numpy(), iou.cpu().numpy(), stab.cpu().numpy(),
                area.cpu().numpy())

    def predict_points_select(self, points_input_frame: np.ndarray,
                              iou_threshold: float = 0.0,
                              stability_threshold: float = 0.90,
                              nms_enabled: bool = True, box_nms_thresh: float = 0.8,
                              filter_by_box_size: bool = True,
                              out_size: int = 256) -> dict:
        """One smallest-good selection round with NMS: the selection dict of
        ``mask_generation.run_round`` (masks (M, hs, ws) bool, iou_preds,
        keypoints_ids in NMS score order, boxes, masks_ids)."""
        handle = self.select_dispatch(points_input_frame, iou_threshold,
                                      stability_threshold, out_size=out_size)
        return self.select_finish(handle, nms_enabled=nms_enabled,
                                  box_nms_thresh=box_nms_thresh,
                                  filter_by_box_size=filter_by_box_size)

    def select_dispatch(self, points_input_frame: np.ndarray, iou_threshold: float,
                        stability_threshold: float, out_size: int = 256) -> dict:
        """Enqueue the decode and selection of one round; no host sync."""
        input_hw, hs, ws = self._grid(out_size)
        pts = self._points(points_input_frame)
        out = self._decode_select(pts, input_hw, out_size, float(iou_threshold),
                                  float(stability_threshold))
        return {"out": out, "n": pts.shape[0], "hs": hs, "ws": ws}

    def select_finish(self, handle: dict, nms_enabled: bool = True,
                      box_nms_thresh: float = 0.8, filter_by_box_size: bool = True,
                      defer_masks: bool = False) -> dict:
        """Fetch a round's per-keypoint scalars, run NMS, and gather the
        survivors.  ``defer_masks=True`` leaves them packed on the device:
        ``masks`` is None and ``deferred`` holds a :class:`DeferredMasks`
        (plus ``coverage`` when NMS ran)."""
        packed, iou_pick, kp_valid, boxes, pick = handle["out"]
        hs, ws, n = handle["hs"], handle["ws"], handle["n"]
        iou_all, valid, boxes_all, pick_all = (
            t.cpu().numpy() for t in (iou_pick, kp_valid, boxes, pick))
        kp_ids = np.nonzero(valid)[0]
        coverage_packed = None
        if nms_enabled and kp_ids.size:
            kept, coverage_packed, order = _select_nms_device(
                packed, iou_pick, kp_valid, boxes, n, box_nms_thresh, filter_by_box_size)
            sel_ids = order[kept[order]]
        else:
            sel_ids = kp_ids
        rows = packed[torch.as_tensor(sel_ids, dtype=torch.int64, device=packed.device)]
        deferred = DeferredMasks(rows, hs, ws, boxes=boxes_all[sel_ids])
        out = {
            "masks": None if defer_masks else deferred.fetch(),
            "iou_preds": iou_all[sel_ids],
            "keypoints_ids": sel_ids,
            "boxes": boxes_all[sel_ids],
            "masks_ids": pick_all[sel_ids],
        }
        if defer_masks:
            out["deferred"] = deferred
            if coverage_packed is not None:
                cov = _unpackbits_lastaxis(coverage_packed)
                out["coverage"] = cov[:hs, :ws].cpu().numpy()
        return out
