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
or, for the device selection path, ``wire_mask_predictor(predictor)``.  A
``normals_fn`` with ``accepts_uint8`` set takes the uint8 image instead (the
real NNET divides by 255 on the device), and a ``mask_predict_fn`` with a
``prepare_frame`` makes the SAM frame at ``infer_resolution`` itself, from the
keyframe's image (the real predictor's, on the device: a ``SamFrame``).
:func:`build_frontend` and :func:`frontend_from_state_dicts` wire the real
nets.

Precision: everything here is float32 except SAM in :func:`build_frontend`,
which opts into bf16 (``SamPredictor(compute_dtype=torch.bfloat16)``): the
ViT encoder (weights cast once, bf16 activations, tanh GELU, the
extended-head attention in persistent windows) and the mask decoder
(weights, features, positional and prompt embeddings cast to bf16, tanh
GELU in the upscaling head).  The prompt
encoder, the logits handed to K3 and the IoU predictions are float32; the
NNET runs in float32.  Both builders turn TF32 off for cuBLAS and cuDNN
(``utils.numerics.float32_matmuls``), so the float32 convolutions and
matmuls stay float32 on the card whoever calls them.

The resizes are ``image/resize.py``'s numpy replacements of the OpenCV
calls the JAX package makes, but for the SAM frame on the real predictor:
its two resizes (to ``infer_resolution``, then to SAM's input) run as one
kernel on the card (``ops/sam_frame``), with the same bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config.schema import Config
from ..convert import nnet_from_flax, nnet_state_dict, sam_from_flax
from ..image.resize import linear_resize, nn_resize
from ..integrate.bini import (
    BiniConfig,
    integrate_normals,
    integrate_normals_cropped,
    segment_bbox_sizes,
)
from ..keyframe import put_keypoints_back
from ..nets.nnet import NNET, predict_normals
from ..nets.sam.image_encoder import config_from_state_dict
from ..nets.sam.predictor import SamFrame, SamPredictor
from ..utils import timing
from ..utils.numerics import float32_matmuls
from .mask_generation import infer_masks
from .post_process import split_disconnected_segments

# Crop-size buckets for the per-segment BiNI solve, smallest first: each
# segment routes to the smallest window its bbox fits (else the full field).
CROP_BUCKETS = (32, 64, 128)


def scale_K(K: np.ndarray, scale_h: float, scale_w: float) -> np.ndarray:
    """Anisotropic K rescale."""
    K = np.asarray(K, np.float64).copy()
    K[0] *= scale_w
    K[1] *= scale_h
    return K


class FrontProcessor:
    """The keyframe frontend on ``device`` (default the card).

    ``timer``: an optional ``utils.timing.StageTimer``; when set, the
    keyframe's stages accumulate in it: ``keyframe`` (the whole call) over
    normals, sam_resize, sam_upload, sam_masks (sam_encode and the rounds),
    bini, host_pack and split.  Counts ``sam_frame_on_card`` for a keyframe
    whose SAM frame the kernel made, ``sam_frame_on_host`` for one made by
    the numpy resizes."""

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

    def process_to_kf(self, image, K, keypoints=None, loose: bool = False) -> dict:
        """One keyframe from ``image`` (uint8 or float [0, 1]) and ``K``;
        ``keypoints`` (B, 2) normalised (row, col) prompts replace round 1's
        random ones.  ``loose`` is depth completion's fallback: SAM without
        NMS and without the smallest-good pick, so every good candidate of
        every prompt becomes a segment (the host selection path, on the
        predictor's statistics).  Counts the keyframe's ``segments``."""
        with timing.span(self.timer, "keyframe"):
            kf = self._keyframe(image, K, keypoints, loose)
            timing.count("segments", kf["regions"].shape[0])
        return kf

    def _keyframe(self, image, K, keypoints, loose: bool) -> dict:
        fc = self.config.frontend
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        H, W = image.shape[:2]
        Hg, Wg = fc.normals.integration_shape
        K_geom = scale_K(K, Hg / H, Wg / W)

        # 1. normals, brought to the integration shape
        img01 = image.astype(np.float32) / 255.0
        with timing.span(self.timer, "normals"):
            normals, _ = self.normals_fn(
                image if getattr(self.normals_fn, "accepts_uint8", False) else img01)
            normals = timing.to_host(normals) if torch.is_tensor(normals) else np.asarray(normals)
            if normals.shape[:2] != (Hg, Wg):
                normals = nn_resize(normals, (Hg, Wg))
            normals_t = torch.from_numpy(np.ascontiguousarray(normals, np.float32)).to(self.device)
        K_t = torch.from_numpy(np.asarray(K_geom, np.float32)).to(self.device)
        bini_cfg = BiniConfig(cg_max_iter=fc.cg_max_iter, cg_tol=fc.cg_tol)

        # 2. SAM masks at infer_resolution.  When the mask contents are
        # final after each round (no cut by edges), round 1's segments start
        # integrating on the device before round 2 runs.
        sam_params = self.config.sam_params
        if loose:
            sam_params = dataclasses.replace(sam_params, nms=False, select_smallest=False)
        sam_hw = tuple(sam_params.infer_resolution)
        prepare = getattr(self.mask_predict_fn, "prepare_frame", None)
        # sam_resize holds the SAM frame's host work, none where the
        # predictor makes the frame; it opens on both paths all the same
        with timing.span(self.timer, "sam_resize"):
            sam_img = linear_resize(image, sam_hw) if prepare is None else None
        if prepare is not None:
            with timing.span(self.timer, "sam_upload"):
                sam_img = prepare(image, sam_hw)
        on_card = isinstance(sam_img, SamFrame) and sam_img.pixels.is_cuda
        timing.count("sam_frame_on_card" if on_card else "sam_frame_on_host")
        predictor = getattr(self.mask_predict_fn, "predictor", None)
        overlap = not sam_params.cut_masks_by_edges
        r1_handle = []

        def on_round1(masks_r1):
            r1_handle.append(self._dispatch_integration(normals_t, masks_r1, K_t, bini_cfg))

        with timing.span(self.timer, "sam_masks"):
            if predictor is not None:
                with timing.span(self.timer, "sam_encode"):
                    predictor.set_image(sam_img)  # the rounds' set_image then finds it
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
        with timing.span(self.timer, "bini"):
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
        with timing.span(self.timer, "host_pack"):
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
            # regions are depth > 1e-7, so no clamp is needed inside them
            np.log(depth_kf, out=logdepth, where=regions)

            dims = np.asarray([H_kf, W_kf], np.float32)
            kp_rc = np.round(0.5 * (dims - 1) * (kps + 1)).astype(np.int64)

        # 5. depth-discontinuity split
        if fc.check_for_depth_disc:
            with timing.span(self.timer, "split"):
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
            zt_c, r0, c0 = (timing.to_host(t) for t in out)
            ch, cw = zt_c.shape[1:]
            for j, i in enumerate(idx):
                rr, cc = int(r0[j]), int(c0[j])
                win = masks[i, rr : rr + ch, cc : cc + cw]
                depth[i, rr : rr + ch, cc : cc + cw] = np.exp(zt_c[j]) * win
        if "full" in handle:
            idx, zt = handle["full"]
            zt = timing.to_host(zt)
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
            normals = timing.to_host(normals) if torch.is_tensor(normals) else np.asarray(normals)
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
    ``dispatch`` / ``finish`` protocol, the contract ``infer_masks`` keys on;
    ``.predictor`` is the predictor, and ``.prepare_frame`` its
    ``prepare_frame`` where it has one.
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
    mask_predict_fn.predictor = predictor
    prepare = getattr(predictor, "prepare_frame", None)
    if prepare is not None:
        mask_predict_fn.prepare_frame = prepare
    return mask_predict_fn


def build_frontend(config: Config, sam_tree: dict, nnet_tree: dict,
                   device: str | torch.device = "cuda") -> FrontProcessor:
    """A FrontProcessor on the real nets, from the JAX package's converted
    parameter trees (``convert.load_npz_tree`` of the ``.npz`` files); see
    :func:`frontend_from_state_dicts`."""
    if sam_tree is None or nnet_tree is None:
        raise ValueError("SAM and NNET parameter trees are both required")
    return frontend_from_state_dicts(config, sam_from_flax(sam_tree), nnet_from_flax(nnet_tree),
                                     device)


def frontend_from_state_dicts(config: Config, sam_sd: dict, nnet_sd: dict,
                              device: str | torch.device = "cuda") -> FrontProcessor:
    """A FrontProcessor on the real nets from state dicts in the published
    names (segment-anything, scannet).

    SAM runs in bf16 (see the module docstring) through the device
    selection path; the NNET in float32, with the nearest subsample to the
    integration shape on the device when ``include_normals`` is off.  The
    ViT configuration is the one the SAM state dict's shapes give."""
    device = torch.device(device)
    float32_matmuls()
    predictor = SamPredictor(sam_sd, config_from_state_dict(sam_sd),
                             compute_dtype=torch.bfloat16, device=device)
    nnet = NNET()
    nnet.load_state_dict(nnet_state_dict(nnet_sd))
    nnet = nnet.to(device).eval().requires_grad_(False)
    fc = config.frontend
    coarse = None if fc.include_normals else tuple(fc.normals.integration_shape)

    def normals_fn(img):
        return predict_normals(nnet, img, tuple(fc.normals.network_dim), coarse_hw=coarse)

    normals_fn.accepts_uint8 = True
    normals_fn.model = nnet
    return FrontProcessor(config, normals_fn, wire_mask_predictor(predictor), device=device)
