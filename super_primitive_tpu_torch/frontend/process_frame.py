"""Perception frontend: normals -> SAM masks -> BiNI integration -> keyframe.

Port of ``super_primitive_tpu/frontend/process_frame.py``
(``FrontProcessor.process_to_kf`` / ``process_to_supp_kf`` and
``wire_mask_predictor``).  Per keyframe:
  1. normals from the injected normal model, NN-resized to the integration
     shape;
  2. SAM mask generation at ``infer_resolution``; on the device selection
     path round 1's survivors stay packed on the card and their BiNI solves
     are launched before round 2;
  3. BiNI integration per segment on ``device``, each segment routed to
     the smallest :data:`CROP_BUCKETS` window its bounding box fits, else
     to the full field;
  4. image downsampled to keyframe size, depth NN-resized, validity
     depth > 1e-7, keypoints snapped into masks, log taken in-mask;
  5. the depth-discontinuity split (``frontend/post_process.py``) when
     ``frontend.check_for_depth_disc`` is set.

Each segment's solve is independent of the batch it is solved in, so the
port solves each round's segments without the JAX package's power-of-two
padding and gets the same result.

Models are injected as callables:
  normals_fn(image_hwc01) -> (normals (H, W, 3), kappa (H, W, 1))
  mask_predict_fn(image_hwc_uint8, keypoints_norm) -> (logits (B,3,H,W), iou)
or, for the device selection path, ``wire_mask_predictor(predictor)``.

The resizes are numpy replacements of the OpenCV calls the JAX package
makes (``cv2.INTER_NEAREST`` and ``cv2.INTER_LINEAR``); the tests hold them
against OpenCV.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..config.schema import Config
from ..integrate.bini import (
    BiniConfig,
    integrate_normals,
    integrate_normals_cropped,
    segment_bbox_sizes,
)
from ..keyframe import put_keypoints_back
from .mask_generation import infer_masks
from .post_process import split_disconnected_segments

# Crop-size buckets for the per-segment BiNI solve, smallest first: each
# segment routes to the smallest window its bbox fits (else the full field).
CROP_BUCKETS = (32, 64, 128)


def _nearest_index(dst: int, src: int) -> np.ndarray:
    """cv2.INTER_NEAREST source index of each destination index:
    floor(i * (1 / (dst / src))) in double, clipped to the last pixel."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def nn_resize(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize with cv2.INTER_NEAREST semantics on (H, W),
    (H, W, C<=4) or leading-batch (N, H, W) arrays."""
    H, W = hw
    batch = not (x.ndim == 2 or (x.ndim == 3 and x.shape[-1] <= 4))
    src_hw = x.shape[-2:] if batch else x.shape[:2]
    if tuple(src_hw) == (H, W):
        return x
    ri = _nearest_index(H, src_hw[0])
    ci = _nearest_index(W, src_hw[1])
    if batch:
        return x[:, ri[:, None], ci[None, :]]
    return x[ri[:, None], ci[None, :]]


def _linear_taps(dst: int, src: int, clamp_weight: bool):
    """Half-pixel-centre source taps and the weight of the second tap, as
    cv2.resize computes them: the column weights are zeroed at the borders,
    the row weights are not (their taps are clipped instead)."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    if clamp_weight:
        f = np.where(s < 0, 0.0, f)
        s = np.where(s < 0, 0, s)
        edge = s >= src - 1
        f = np.where(edge, 0.0, f)
        s = np.where(edge, src - 1, s)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f.astype(np.float32)


def linear_resize(x: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) uint8 or float32 image with
    cv2.INTER_LINEAR semantics.

    An exact 2x reduction is a 2x2 mean, as OpenCV takes it; uint8 rounds it
    half up.  Other ratios use OpenCV's separable taps: uint8 with its 11-bit
    fixed-point weights and its vectorised rounding, float32 in float32."""
    H, W = hw
    Hs, Ws = x.shape[:2]
    if (Hs, Ws) == (H, W):
        return x.copy()
    if Hs == 2 * H and Ws == 2 * W:
        a, b = x[0::2, 0::2], x[0::2, 1::2]
        c, d = x[1::2, 0::2], x[1::2, 1::2]
        if x.dtype == np.uint8:
            s = a.astype(np.int32) + b + c + d
            return ((s + 2) >> 2).astype(np.uint8)
        return ((a + b) + (c + d)) * np.float32(0.25)
    sy, sy1, fy = _linear_taps(H, Hs, clamp_weight=False)
    sx, sx1, fx = _linear_taps(W, Ws, clamp_weight=True)
    if x.dtype == np.uint8:
        one = 2048  # 1 << INTER_RESIZE_COEF_BITS
        ax0 = np.round((1.0 - fx) * one).astype(np.int64)[None, :, None]
        ay0 = np.round((1.0 - fy) * one).astype(np.int64)[:, None, None]
        xi = x.astype(np.int64)
        hor = xi[:, sx] * ax0 + xi[:, sx1] * (one - ax0)
        out = (
            (((hor[sy] >> 4) * ay0) >> 16) + (((hor[sy1] >> 4) * (one - ay0)) >> 16) + 2
        ) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    wx = fx[None, :, None]
    wy = fy[:, None, None]
    hor = x[:, sx] * (1.0 - wx) + x[:, sx1] * wx
    return (hor[sy] * (1.0 - wy) + hor[sy1] * wy).astype(np.float32)


def scale_K(K: np.ndarray, scale_h: float, scale_w: float) -> np.ndarray:
    """Anisotropic K rescale."""
    K = np.asarray(K, np.float64).copy()
    K[0] *= scale_w
    K[1] *= scale_h
    return K


class FrontProcessor:
    """The keyframe frontend on ``device`` (default the card).

    ``timer``: an optional ``utils.timing.StageTimer``; when set, the
    keyframe stages (normals, sam_masks and its rounds, bini, host_pack,
    split) accumulate in it."""

    def __init__(
        self,
        config: Config,
        normals_fn: Callable,
        mask_predict_fn: Callable,
        rng: Optional[np.random.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config
        self.normals_fn = normals_fn
        self.mask_predict_fn = mask_predict_fn
        self.rng = rng or np.random.default_rng(42)
        self.device = torch.device(device)
        self.timer = None

    def _stage(self, name):
        return self.timer.stage(name) if self.timer else contextlib.nullcontext()

    def process_to_kf(self, image, K, keypoints=None) -> dict:
        fc = self.config.frontend
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        H, W = image.shape[:2]
        Hg, Wg = fc.normals.integration_shape
        K_geom = scale_K(K, Hg / H, Wg / W)

        # 1. normals, brought to the integration shape
        img01 = image.astype(np.float32) / 255.0
        with self._stage("normals"):
            normals, _ = self.normals_fn(img01)
            normals = normals.cpu().numpy() if torch.is_tensor(normals) else np.asarray(normals)
            if normals.shape[:2] != (Hg, Wg):
                normals = nn_resize(normals, (Hg, Wg))
            normals_t = torch.from_numpy(np.ascontiguousarray(normals, np.float32)).to(self.device)
        K_t = torch.from_numpy(np.asarray(K_geom, np.float32)).to(self.device)
        bini_cfg = BiniConfig(cg_max_iter=fc.cg_max_iter, cg_tol=fc.cg_tol)

        # 2. SAM masks at infer_resolution.  When the mask contents are
        # final after each round (no cut by edges), round 1's segments start
        # integrating on the device before round 2 runs.
        sam_params = self.config.sam_params
        sam_hw = sam_params.infer_resolution
        sam_img = linear_resize(image, (sam_hw[0], sam_hw[1]))
        overlap = not sam_params.cut_masks_by_edges
        r1_handle = []

        def on_round1(masks_r1):
            r1_handle.append(self._dispatch_integration(normals_t, masks_r1, K_t, bini_cfg))

        with self._stage("sam_masks"):
            gen = infer_masks(
                self.mask_predict_fn, sam_img, sam_params,
                keypoints=keypoints,
                num_pts=fc.num_pts, num_pts_active=fc.num_pts_active,
                rng=self.rng, edge_probs_shape=(Hg, Wg), device=self.device,
                on_round1=on_round1 if overlap else None, timer=self.timer,
            )
        masks = gen["masks"]
        if masks.shape[0] == 0:
            raise RuntimeError("frontend produced no masks")

        # 3. BiNI integration per segment at geometry resolution
        with self._stage("bini"):
            if overlap:
                depth_perseg = np.zeros((masks.shape[0], Hg, Wg), np.float32)
                is_r1 = gen["src_round"] == 0
                if r1_handle and r1_handle[0] is not None and is_r1.any():
                    d1 = self._composite_integration(r1_handle[0])
                    depth_perseg[is_r1] = d1[gen["src_idx"][is_r1]]
                if (~is_r1).any():
                    h2 = self._dispatch_integration(normals_t, masks[~is_r1], K_t, bini_cfg)
                    depth_perseg[~is_r1] = self._composite_integration(h2)
            else:
                depth_perseg = self.integrate(normals, masks, K_geom, bini_cfg)

        # 4. downsample image to KF size; depth NN-resized; log in-mask
        with self._stage("host_pack"):
            s = 2 ** fc.downsample_pow
            H_kf, W_kf = H // s, W // s
            K_kf = scale_K(K, H_kf / H, W_kf / W)
            image_kf = linear_resize(img01, (H_kf, W_kf)).astype(np.float32)
            if fc.include_normals:
                n_kf = nn_resize(normals, (H_kf, W_kf)).astype(np.float32)
                image_kf = np.concatenate([image_kf, n_kf], axis=-1)

            depth_kf = nn_resize(depth_perseg, (H_kf, W_kf))
            regions = depth_kf > 1e-7
            kps, regions, depth_kf = put_keypoints_back(gen["keypoints"], regions, depth_kf)
            logdepth = np.zeros(depth_kf.shape, np.float32)
            np.log(np.maximum(depth_kf, 1e-30), out=logdepth, where=regions)

            dims = np.asarray([H_kf, W_kf], np.float32)
            kp_rc = np.round(0.5 * (dims - 1) * (kps + 1)).astype(np.int64)

        # 5. depth-discontinuity split
        if fc.check_for_depth_disc:
            with self._stage("split"):
                dp = fc.depth_disc_params
                regions, logdepth, kp_rc = split_disconnected_segments(
                    regions, logdepth, kp_rc, dp.filter_size, dp.depth_threshold,
                    dp.area_keep_ratio, rng=self.rng, device=self.device, timer=self.timer,
                )
        return {
            "image": image_kf,
            "K": K_kf.astype(np.float32),
            "regions": regions,
            "logdepth_perseg": logdepth,
            "keypoints_rc": kp_rc,
            "normals": normals,
            "edges": gen["edges"],
        }

    def _dispatch_integration(self, normals_t, masks, K_t, bini_cfg,
                              crop: int | None = None) -> Optional[dict]:
        """Launch per-segment BiNI on ``self.device`` for host masks (M, h, w)
        or a ``DeferredMasks`` (masks still packed on the device), each
        segment routed to the smallest :data:`CROP_BUCKETS` window its
        integration-shape bbox fits, else to the full field; ``crop`` forces
        one bucket.  Returns a handle for :meth:`_composite_integration`
        (None for no masks); nothing waits for the device here."""
        Hg, Wg = normals_t.shape[:2]
        deferred = getattr(masks, "device_masks_resized", None) is not None
        if deferred and (masks.n_rows == 0 or Hg < masks.hs or Wg < masks.ws):
            # the boxes give exact resized bboxes only when resizing up
            masks, deferred = masks.fetch(), False
        if deferred:
            hs, ws = masks.resized_bbox_sizes(Hg, Wg)
            handle = {"deferred": masks}

            def device_masks(idx):
                return masks.device_masks_resized(idx, Hg, Wg)
        else:
            if masks.shape[0] == 0:
                return None
            mc = nn_resize(np.asarray(masks, bool), (Hg, Wg)).astype(bool)
            hs, ws = segment_bbox_sizes(mc)
            mc_t = torch.from_numpy(mc).to(self.device)
            handle = {"masks": mc}

            def device_masks(idx):
                return mc_t[torch.from_numpy(idx).to(self.device)]

        ext = np.maximum(hs, ws)
        assigned = np.zeros(ext.shape[0], bool)
        handle["geo"] = (Hg, Wg)
        handle["buckets"] = []
        for c in sorted(CROP_BUCKETS if crop is None else (crop,)):
            sel = (~assigned) & (ext <= c)
            if sel.any():
                idx = np.nonzero(sel)[0]
                out = integrate_normals_cropped(normals_t, device_masks(idx), K_t, bini_cfg,
                                                c, return_crops=True)
                handle["buckets"].append((idx, out))
                assigned |= sel
        if (~assigned).any():
            idx = np.nonzero(~assigned)[0]
            handle["full"] = (idx, integrate_normals(normals_t, device_masks(idx), K_t, bini_cfg))
        return handle

    def _composite_integration(self, handle: dict) -> np.ndarray:
        """Per-segment depth fields (M, Hg, Wg) on the host from a
        :meth:`_dispatch_integration` handle: exp of the log-depth inside
        the mask, zero outside."""
        masks = handle.get("masks")
        if masks is None:
            masks = nn_resize(handle["deferred"].fetch(), handle["geo"]).astype(bool)
        depth = np.zeros(masks.shape, np.float32)
        for idx, out in handle["buckets"]:
            zt_c, r0, c0 = (t.cpu().numpy() for t in out)
            ch, cw = zt_c.shape[1:]
            for j, i in enumerate(idx):
                rr, cc = int(r0[j]), int(c0[j])
                win = masks[i, rr : rr + ch, cc : cc + cw]
                depth[i, rr : rr + ch, cc : cc + cw] = np.exp(zt_c[j]) * win
        if "full" in handle:
            idx, zt = handle["full"]
            zt = zt.cpu().numpy()
            for j, i in enumerate(idx):
                depth[i] = np.exp(zt[j]) * masks[i]
        return depth

    def integrate(
        self, normals: np.ndarray, masks: np.ndarray, K_geom: np.ndarray,
        bini_cfg: BiniConfig, crop: int | None = None,
    ) -> np.ndarray:
        """Per-segment BiNI on ``self.device`` with crop/full routing for host
        masks at the integration shape; returns depth fields (N, H, W) on the
        host: exp of the log-depth inside the mask, zero outside.  ``crop``
        forces a single bucket."""
        normals_t = torch.from_numpy(np.ascontiguousarray(normals, np.float32)).to(self.device)
        K_t = torch.from_numpy(np.asarray(K_geom, np.float32)).to(self.device)
        handle = self._dispatch_integration(normals_t, masks, K_t, bini_cfg, crop)
        if handle is None:
            return np.zeros((0,) + normals.shape[:2], np.float32)
        return self._composite_integration(handle)

    def process_to_supp_kf(self, image, K) -> dict:
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        s = 2 ** self.config.frontend.downsample_pow
        H, W = image.shape[:2]
        H_kf, W_kf = H // s, W // s
        img = linear_resize(image.astype(np.float32), (H_kf, W_kf))
        if self.config.frontend.include_normals:
            normals, _ = self.normals_fn(image)
            normals = normals.cpu().numpy() if torch.is_tensor(normals) else np.asarray(normals)
            n_kf = nn_resize(normals, (H_kf, W_kf)).astype(np.float32)
            img = np.concatenate([img, n_kf], axis=-1)
        return {
            "image": img,
            "K": scale_K(K, H_kf / H, W_kf / W).astype(np.float32),
        }


def wire_mask_predictor(predictor):
    """mask_generation-protocol wrappers around a prompt-round predictor
    (``nets/sam/predictor.PromptRounds``, e.g. ``fakes.DeviceFakeSAM``).

    Returns ``mask_predict_fn`` (the statistics path) with ``.select_round``
    attached: one selection round with NMS on the device, plus its two-phase
    ``dispatch`` / ``finish`` protocol, the contract ``infer_masks`` keys on.
    """

    def _to_input_xy(image_uint8, kps_norm):
        predictor.set_image(image_uint8)
        h2, w2 = predictor._input_hw
        # keypoints normalized (row, col) -> input-frame (x, y) pixels
        dims = np.asarray([h2, w2], np.float32)
        rc = 0.5 * (dims - 1) * (np.asarray(kps_norm) + 1)
        return np.round(rc[:, ::-1])

    def mask_predict_fn(image_uint8, kps_norm):
        return predictor.predict_points_with_stats(_to_input_xy(image_uint8, kps_norm),
                                                   out_size=256)

    def select_round(image_uint8, kps_norm, sam_params):
        return predictor.predict_points_select(
            _to_input_xy(image_uint8, kps_norm),
            iou_threshold=sam_params.iou_threshold,
            stability_threshold=sam_params.stability_threshold,
            nms_enabled=sam_params.nms,
            box_nms_thresh=sam_params.box_nms_thresh,
            filter_by_box_size=sam_params.filter_by_box_size,
            out_size=256,
        )

    def _select_dispatch(image_uint8, kps_norm, sam_params):
        return predictor.select_dispatch(
            _to_input_xy(image_uint8, kps_norm),
            iou_threshold=sam_params.iou_threshold,
            stability_threshold=sam_params.stability_threshold,
            out_size=256,
        )

    def _select_finish(handle, sam_params, defer_masks=False):
        return predictor.select_finish(
            handle,
            nms_enabled=sam_params.nms,
            box_nms_thresh=sam_params.box_nms_thresh,
            filter_by_box_size=sam_params.filter_by_box_size,
            defer_masks=defer_masks,
        )

    select_round.dispatch = _select_dispatch
    select_round.finish = _select_finish
    mask_predict_fn.select_round = select_round
    return mask_predict_fn
