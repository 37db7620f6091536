"""SAM predictor: encode an image once, decode point prompts, and select
masks on the device.

Port of ``super_primitive_tpu/nets/sam/predictor.py``.

The encode and decode half (:class:`Sam`, :class:`SamPredictor`): resize
the longest side to ``target_length`` (cv2 INTER_LINEAR semantics, by
``image/resize.linear_resize``), normalise with ``PIXEL_MEAN`` /
``PIXEL_STD``, zero-pad to a square, encode with the ViT
(:meth:`SamPredictor.prepare_frame` makes the resized frame on the device
from the keyframe's own image instead, both of the JAX package's
``cv2.resize`` calls in one kernel, ``ops/sam_frame``); then per prompt
the prompt encoder (one positive point and the label -1 pad point SAM
appends when there is no box) and the mask decoder give 4 low-res mask
logits, of which mask 0 is dropped (multimask output).  With
``compute_dtype=torch.bfloat16`` the encoder and the decoder run in bf16
with tanh GELU (their weights cast once), the encoder lowered as the JAX
package's bf16 predictor lowers it (extended-head attention, persistent
windows); the prompt encoder and every output stay float32.

The selection half: from (B, M, S, S) low-res mask logits and (B, M) IoU
predictions, the full-resolution stability and area of every candidate
come from kernel K3 (``ops/phase_counts.py``, the phase decomposition of
the bilinear upsample), then the amg smallest-good pick, the picked masks
bit-packed MSB-first, their xyxy boxes, greedy box NMS, and the survivors
left packed on the device (:class:`DeferredMasks`) until a caller needs
them.  :class:`PromptRounds` holds the four prompt-round methods over a
subclass's decode: :class:`SamPredictor` here, ``frontend/fakes.
DeviceFakeSAM`` on structured fake logits.

A selection round decodes all its prompts in one batch (the JAX package
pads them to a multiple of 64; PyTorch compiles nothing per shape, so the
port does not pad).  The statistics path decodes in chunks of
:data:`STATS_CHUNK` prompts, as the JAX package does: the decoder's
(B, 32, 256, 256) upscaling activations then stay a chunk's size, and each
prompt's outputs do not depend on the others in its batch.  The greedy NMS
walks its order on the host over one fetched (C, C) overlap matrix.  None
of this changes an output.

Over a process group (``parallel.mesh``): :meth:`SamPredictor.encode_batch`
shards an image batch, :meth:`SamPredictor._decode_select` a round's
prompts (K3 runs on each rank's own), and ``gather_rows`` returns every
output in the unsharded order, so NMS after the gather sees the same keep
order.  A predictor built with ``encoder=False`` decodes against features
encoded elsewhere (:meth:`SamPredictor.set_features`).

At ``out_size != S`` the statistics and the selection threshold logits
resized to the out_size grid by ``image/resize.resize_bilinear``
(``jax.image.resize`` semantics); K3 still counts on the low-res logits.
:meth:`SamPredictor.predict_batched_points` returns full-resolution logits
(:meth:`SamPredictor.postprocess_masks`: up to the model's square input,
the padding cropped, down to the original image), in chunks of 64 prompts
padded to the chunk, as the JAX package decodes them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...image.resize import linear_resize, resize_bilinear
from ...ops import phase_counts as k3
from ...ops import sam_frame as frame_op
from ...parallel.mesh import gather_rows, shard_rows
from ...utils import timing
from .image_encoder import VIT_H, ImageEncoderViT, ViTConfig
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MASK_THRESHOLD = 0.0
STATS_CHUNK = 128  # prompts a decode on the statistics path
BATCHED_CHUNK = 64  # prompts a decode in predict_batched_points
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
    binary masks on the out_size grid (padding zeroed; the logits resized
    to it first when out_size != S), the IoU predictions, and K3's
    full-resolution stability and area, each (B, M)."""
    B, M, S = lowres.shape[0], lowres.shape[1], lowres.shape[-1]
    x = lowres.reshape(B * M, S, S)
    stability, areas = phase_upsample_counts(x, target_length // S, input_hw)
    xb = x if out_size == S else resize_bilinear(x, (out_size, out_size))
    masks_bin = (xb > MASK_THRESHOLD) & _region(out_size, input_hw, target_length, x.device)
    packed = _packbits_lastaxis(masks_bin)
    return (packed.reshape(B, M, out_size, out_size // 8), iou,
            stability.reshape(B, M), areas.reshape(B, M))


def select_from_lowres(lowres, iou, input_hw, out_size: int, iou_thr: float,
                       stab_thr: float, target_length: int):
    """amg smallest-good selection from (B, M, S, S) low-res logits on their
    device: per-candidate IoU and stability filter (K3 statistics), a
    keypoint is valid iff it has a good candidate, the smallest good mask by
    full-resolution area is picked.  Returns (packed picked masks (B,
    out_size, out_size/8) uint8, picked IoU (B,), valid (B,) bool, xyxy boxes (B, 4) float32
    on the out_size grid (zeros for empty masks), pick (B,))."""
    B, M, S = lowres.shape[0], lowres.shape[1], lowres.shape[-1]
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

    if out_size != S:
        picked = resize_bilinear(picked, (out_size, out_size))
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
    over = timing.to_host(ious > nms_thr)
    order_h, valid_h = timing.to_host(order), timing.to_host(valid)

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
        return timing.to_host(cov[: self.hs, : self.ws])

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
            self._host = timing.to_host(m)
        return self._host


class SamFrame:
    """An image at the mask generation's resolution whose pixels are never
    on the host: SAM's input frame made from it on the device
    (:meth:`SamPredictor.prepare_frame`).  It stands where that image
    stood, for :meth:`SamPredictor.set_image` and the prompt rounds:
    ``shape`` is the image's (h, w, 3), and the object itself is what the
    predictor's cache of the encoded image keys on."""

    def __init__(self, pixels: torch.Tensor, hw: tuple[int, int]):
        self.pixels = pixels  # (h2, w2, 3) uint8 input frame
        self.shape = (int(hw[0]), int(hw[1]), int(pixels.shape[2]))


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
        counts.  The prompts are decoded :data:`STATS_CHUNK` at a time, and
        the chunks' packed masks and statistics come to the host together."""
        input_hw, hs, ws = self._grid(out_size)
        pts = self._points(points_input_frame)
        parts = [self._decode_stats(pts[lo:lo + STATS_CHUNK], input_hw, out_size)
                 for lo in range(0, pts.shape[0], STATS_CHUNK)]
        packed, iou, stab, area = (torch.cat(ts) for ts in zip(*parts))
        bits = _unpackbits_lastaxis(packed)[..., :hs, :ws]
        return tuple(timing.to_host(t) for t in (bits, iou, stab, area))

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
            timing.to_host(t) for t in (iou_pick, kp_valid, boxes, pick))
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
                out["coverage"] = timing.to_host(cov[:hs, :ws])
        return out


class Sam(nn.Module):
    """The three SAM networks under their published segment-anything names
    (``image_encoder``, ``prompt_encoder``, ``mask_decoder``)."""

    def __init__(self, cfg: ViTConfig = VIT_H):
        super().__init__()
        S = cfg.img_size // cfg.patch_size
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg.out_chans, (S, S), (cfg.img_size, cfg.img_size))
        self.mask_decoder = MaskDecoder(cfg.out_chans, gelu_approx=cfg.gelu_approx)


def build_sam(params, cfg: ViTConfig, device, encoder: bool = True) -> Sam:
    """A :class:`Sam` on ``device`` holding ``params`` (a state dict, numpy
    or tensors, in the published names; every key must be there), in
    inference mode (no gradients).  ``encoder=False`` leaves the image
    encoder unbuilt (on the meta device) and reads none of its keys."""
    with torch.device("meta"):
        model = Sam(cfg)
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          .to(device=device, dtype=torch.float32, copy=True)
          for k, v in params.items() if encoder or not k.startswith("image_encoder.")}
    missing, unexpected = model.load_state_dict(sd, assign=True, strict=encoder)
    missing = [k for k in missing if not k.startswith("image_encoder.")]
    if missing or unexpected:
        raise RuntimeError(f"SAM state dict: missing {missing}, unexpected {unexpected}")
    return model.eval().requires_grad_(False)


def decode_prompts(prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder,
                   features: torch.Tensor, image_pe: torch.Tensor, pts: torch.Tensor,
                   compute_dtype=None):
    """Single positive point prompts (B, 2) float32 (x, y) in input-frame
    pixels, each with SAM's label -1 pad point, on (1, S, S, C) image
    features -> (masks (B, 4, 4S, 4S), iou (B, 4)) float32.  With
    ``compute_dtype`` the decoder (already cast to it) runs on the features,
    positional encoding and prompt embeddings cast to it."""
    B = pts.shape[0]
    coords = torch.stack([pts, torch.zeros_like(pts)], dim=1)
    labels = torch.tensor([1.0, -1.0], device=pts.device).expand(B, 2)
    sparse, dense = prompt_encoder(coords, labels)
    if compute_dtype is not None:
        features, image_pe, sparse, dense = (
            t.to(compute_dtype) for t in (features, image_pe, sparse, dense))
    masks, iou = mask_decoder(features, image_pe, sparse, dense)
    return masks.float(), iou.float()


class SamPredictor(PromptRounds):
    """Holds the SAM networks on ``device`` and the features of the image
    last set; stateful per image, like the reference predictor.

    ``params``: a segment-anything state dict (``convert.sam_from_flax`` of
    the JAX package's tree, or ``nets/synth.synth_sam_state_dict``).
    ``compute_dtype``: None keeps float32 with exact GELU (the parity
    path); ``torch.bfloat16`` casts the encoder and decoder weights once
    and runs them in bf16, and where ``cfg.global_attn_impl`` is "xla"
    lowers the encoder as the JAX package's bf16 predictor does ("ext"
    attention in every block, persistent windows, tanh GELU); a ``cfg``
    with another global lowering ("flash": K4) runs as it is.  ``encoder=False``: decode only,
    on features from :meth:`set_features` (no image encoder is built)."""

    def __init__(self, params, cfg: ViTConfig = VIT_H, compute_dtype=None,
                 device: str | torch.device = "cuda", encoder: bool = True):
        if compute_dtype is not None and cfg.global_attn_impl == "xla":
            # the JAX package's reduced-precision lowering: extended-head
            # rel-pos in the global and windowed blocks, persistent windows
            # and tanh GELU (same parameters; the float32 path keeps the
            # materialised bias and the exact erf GELU)
            cfg = dataclasses.replace(cfg, global_attn_impl="ext", windowed_attn_impl="ext",
                                      persistent_windows=True, gelu_approx=True)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.model = build_sam(params, cfg, self.device, encoder=encoder)
        if compute_dtype is not None:
            self.model.image_encoder.to(compute_dtype)
            self.model.mask_decoder.to(compute_dtype)
        self.target_length = cfg.img_size
        self._image_pe = self.model.prompt_encoder.get_dense_pe()
        self._mean = torch.tensor(PIXEL_MEAN, device=self.device)
        self._std = torch.tensor(PIXEL_STD, device=self.device)
        self._features = None
        self._input_hw = None
        self._orig_hw = None
        self._last_image = None
        self._staging = None  # (pinned buffer, event after its last copy)

    # -------------------------------------------------------------- image
    def _upload(self, image_hwc_uint8: np.ndarray) -> torch.Tensor:
        """The input frame of an image given at its own size: the longest
        side resized on the host (``linear_resize``), then copied to the
        device; (h2, w2, 3) uint8."""
        H, W = image_hwc_uint8.shape[:2]
        h2, w2 = get_preprocess_shape(H, W, self.target_length)
        host = linear_resize(np.asarray(image_hwc_uint8), (h2, w2))
        return torch.from_numpy(host).to(self.device)

    def _stage(self, image_hwc_uint8: np.ndarray) -> torch.Tensor:
        """The uint8 image on the device.  To a card it goes through one
        pinned buffer that the predictor keeps, without blocking; the
        buffer is written again only once the event recorded after its last
        copy has passed, so no copy reads bytes of a later image."""
        image = np.asarray(image_hwc_uint8)
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected an (H, W, 3) uint8 image, got {image.shape} {image.dtype}")
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(image))
        if self._staging is None or self._staging[0].shape != image.shape:
            self._staging = (torch.empty(image.shape, dtype=torch.uint8, pin_memory=True),
                             torch.cuda.Event())
        else:
            self._staging[1].synchronize()
        buf, copied = self._staging
        buf.numpy()[...] = image
        dev = buf.to(self.device, non_blocking=True)
        copied.record(torch.cuda.current_stream(self.device))
        return dev

    def prepare_frame(self, image_hwc_uint8: np.ndarray, infer_hw: tuple[int, int]) -> SamFrame:
        """The image resized to ``infer_hw`` as :meth:`set_image` takes it,
        made on the device: the (H, W, 3) uint8 image is uploaded and
        ``ops/sam_frame`` resizes it to ``infer_hw`` and that to the input
        frame in one pass (the plain version for a CPU predictor), the same
        bytes as :meth:`set_image` of ``linear_resize(image, infer_hw)``
        would encode.  No pixel at ``infer_hw`` is made on the host."""
        infer_hw = (int(infer_hw[0]), int(infer_hw[1]))
        input_hw = get_preprocess_shape(*infer_hw, self.target_length)
        return SamFrame(frame_op.sam_frame(self._stage(image_hwc_uint8), infer_hw, input_hw),
                        infer_hw)

    def encode(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(h2, w2, 3) uint8 on the device -> (1, S, S, C) float32 features:
        normalise, zero-pad to the square input, encode."""
        T = self.target_length
        x = (img_u8.float() - self._mean) / self._std
        x = F.pad(x, (0, 0, 0, T - x.shape[1], 0, T - x.shape[0]))[None]
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self.model.image_encoder(x).float()

    def encode_batch(self, images: torch.Tensor, group=None) -> torch.Tensor:
        """(B, T, T, 3) float32 encoder inputs (normalised and padded, as
        :meth:`encode` makes them) -> (B, S, S, C) float32 features.
        ``group``: the batch shards over it, the features gather in batch
        order."""
        x, part = shard_rows(images, group)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return gather_rows(self.model.image_encoder(x).float(), part)

    def set_features(self, features: torch.Tensor, input_hw: tuple[int, int],
                     orig_hw: tuple[int, int] | None = None):
        """Decode the following prompts against (1, S, S, C) ``features`` of
        an image whose resized frame is ``input_hw``; ``orig_hw``, the
        image's own size, is what :meth:`predict_batched_points` resizes
        to."""
        self._features = features.to(self.device, torch.float32)
        self._input_hw = tuple(input_hw)
        self._orig_hw = None if orig_hw is None else tuple(orig_hw)
        self._last_image = None

    def set_image(self, image_hwc_uint8):
        """Resize the longest side, normalise, pad and encode: an (H, W, 3)
        uint8 array is resized on the host, a :class:`SamFrame` from
        :meth:`prepare_frame` is resized already.  Setting the same object
        twice in a row encodes once (the two prompt rounds of a keyframe
        share the image)."""
        if self._features is not None and self._last_image is image_hwc_uint8:
            return
        if isinstance(image_hwc_uint8, SamFrame):
            dev = image_hwc_uint8.pixels
        else:
            dev = self._upload(image_hwc_uint8)
        self._features = self.encode(dev)
        self._last_image = image_hwc_uint8
        self._input_hw = tuple(dev.shape[:2])
        self._orig_hw = tuple(image_hwc_uint8.shape[:2])

    # ------------------------------------------------------------- decode
    def _decode(self, pts: torch.Tensor):
        if self._features is None:
            raise RuntimeError("call set_image first")
        return decode_prompts(self.model.prompt_encoder, self.model.mask_decoder,
                              self._features, self._image_pe, pts, self.compute_dtype)

    def predict_batched_points(self, points_input_frame: np.ndarray,
                               chunk: int = BATCHED_CHUNK):
        """Single positive point prompts (B, 2) (x, y) in the resized input
        frame -> (logits (B, 3, H, W) float32 at the original image's size,
        IoU (B, 3)) on the host; mask 0 of the multimask output dropped.
        The prompts run ``chunk`` at a time, each chunk padded to ``chunk``
        with (0, 0) prompts, so no more than chunk x 3 full-resolution
        logits are on the device at once."""
        if self._features is None or self._orig_hw is None:
            raise RuntimeError("call set_image first")
        pts_all = np.asarray(points_input_frame, np.float32).reshape(-1, 2)
        masks, ious = [], []
        for lo in range(0, pts_all.shape[0], chunk):
            part = pts_all[lo:lo + chunk]
            n = part.shape[0]
            part = np.concatenate([part, np.zeros((chunk - n, 2), np.float32)])
            lowres, iou = self._decode(self._points(part))
            masks.append(timing.to_host(self.postprocess_masks(lowres[:n, 1:])))
            ious.append(timing.to_host(iou[:n, 1:]))
        return np.concatenate(masks), np.concatenate(ious)

    def postprocess_masks(self, lowres_masks: torch.Tensor) -> torch.Tensor:
        """(B, M, S, S) low-res logits -> (B, M, H, W) at the original image's
        size: bilinear up to the model's square input, the padding cropped,
        bilinear to (H, W) (``jax.image.resize`` semantics, the JAX
        predictor's ``postprocess_masks``)."""
        B, M, S = lowres_masks.shape[0], lowres_masks.shape[1], lowres_masks.shape[-1]
        T = self.target_length
        x = resize_bilinear(lowres_masks.reshape(B * M, S, S), (T, T))
        h2, w2 = self._input_hw
        x = resize_bilinear(x[:, :h2, :w2], self._orig_hw)
        return x.reshape(B, M, *self._orig_hw)

    def _decode_stats(self, pts, input_hw, out_size):
        lowres, iou = self._decode(pts)
        return stats_from_lowres(lowres[:, 1:], iou[:, 1:], input_hw, out_size,
                                 self.target_length)

    def _decode_select(self, pts, input_hw, out_size, iou_thr, stab_thr, group=None):
        """``group``: the prompts shard over it; (packed, iou, valid, boxes,
        pick) gather in prompt order."""
        pts, part = shard_rows(pts, group)
        lowres, iou = self._decode(pts)
        out = select_from_lowres(lowres[:, 1:], iou[:, 1:], input_hw, out_size, iou_thr,
                                 stab_thr, self.target_length)
        return tuple(gather_rows(t, part) for t in out)
