"""Structured fake SAM / NNET models for checkpoint-free runs.

Port of ``super_primitive_tpu/frontend/fakes.py`` (``FakeSAM``,
``FakeNNET``, ``DeviceFakeSAM`` and ``StructuredFakeFrontend``).
Random-weight nets give degenerate masks, so these fakes are structured:
FakeSAM emits coherent blob masks (a seeded anisotropic Voronoi
over-segmentation, three nested candidates per query point, mimicking SAM's
part/object/scene multimask) on the host; DeviceFakeSAM emits Voronoi
margin logits on SAM's 256x256 low-res grid on the device and runs the
device selection path after them; FakeNNET emits the analytic camera-frame
normals of a ``data.synthetic.PlanesScene``.

They plug into the real FrontProcessor through its injected-model seams, so
the whole keyframe path runs: two-round mask generation with stability
filtering, NMS and active resampling, coarse edge maps, crop/full-routed
BiNI integration on the card, keypoint snapping and the depth split.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.schema import Config
from ..nets.sam.predictor import (
    PromptRounds,
    get_preprocess_shape,
    select_from_lowres,
    stats_from_lowres,
)
from ..utils.numerics import sqrt_rn
from .process_frame import FrontProcessor, wire_mask_predictor


class FakeSAM:
    """Seeded Voronoi blob masks with SAM's (B, 3, H, W) multimask contract.

    Candidate 0 is the query's cell (part-like), candidates 1 and 2 its
    dilations (object/scene-like).  Smallest-good selection therefore picks
    the exact Voronoi cell, so chosen masks tile the image with near-complete
    coverage — like real SAM output on textured scenes.
    """

    def __init__(self, n_cells: int = 48, seed: int = 0, morph_iters: int = 2):
        self.n_cells = n_cells
        self.seed = seed
        self.morph_iters = morph_iters
        self._cache: dict[tuple[int, int], tuple] = {}

    def _cells(self, H: int, W: int):
        key = (H, W)
        if key not in self._cache:
            from scipy.ndimage import binary_dilation

            r = np.random.default_rng(self.seed)
            seeds = np.stack(
                [r.uniform(0, H, self.n_cells), r.uniform(0, W, self.n_cells)],
                axis=1,
            )
            aniso = r.uniform(0.6, 1.6, (self.n_cells, 2))
            u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                               np.arange(H, dtype=np.float32))
            d2 = (
                ((v[None] - seeds[:, 0, None, None]) * aniso[:, 0, None, None]) ** 2
                + ((u[None] - seeds[:, 1, None, None]) * aniso[:, 1, None, None]) ** 2
            )
            labels = np.argmin(d2, axis=0)
            small = np.zeros((self.n_cells, H, W), bool)
            mid = np.zeros((self.n_cells, H, W), bool)
            big = np.zeros((self.n_cells, H, W), bool)
            for i in range(self.n_cells):
                m = labels == i
                small[i] = m
                mid[i] = binary_dilation(m, iterations=self.morph_iters)
                big[i] = binary_dilation(m, iterations=3 * self.morph_iters)
            self._cache[key] = (labels, small, mid, big)
        return self._cache[key]

    def __call__(self, image: np.ndarray, kps_norm: np.ndarray):
        H, W = image.shape[:2]
        labels, small, mid, big = self._cells(H, W)
        dims = np.asarray([H, W], np.float32)
        rc = np.round(0.5 * (dims - 1) * (np.asarray(kps_norm) + 1)).astype(np.int64)
        rc[:, 0] = np.clip(rc[:, 0], 0, H - 1)
        rc[:, 1] = np.clip(rc[:, 1], 0, W - 1)
        cell = labels[rc[:, 0], rc[:, 1]]
        logits = np.stack(
            [small[cell], mid[cell], big[cell]], axis=1
        ).astype(np.float32) * 20.0 - 10.0                      # (B, 3, H, W)
        iou = np.tile(
            np.asarray([0.88, 0.97, 0.92], np.float32), (len(cell), 1)
        )
        return logits, iou


class FakeNNET:
    """Analytic scene normals in place of the normal net.

    The runner's ``observe(frame)`` hook supplies the frame's pose; the
    callable then renders the PlanesScene's camera-frame normals at the
    requested image resolution (kappa is a constant high-confidence field —
    the reference computes but never consumes it, SURVEY §2.4).
    """

    def __init__(self, scene, coarse_hw: tuple[int, int] | None = None):
        self.scene = scene
        self.coarse_hw = coarse_hw
        self._T = np.eye(4)
        self._K = None
        self._native_hw = None

    def observe(self, T_wc: np.ndarray, K: np.ndarray, hw: tuple[int, int]):
        self._T = np.asarray(T_wc, np.float64)
        self._K = np.asarray(K, np.float64)
        self._native_hw = hw

    def __call__(self, img01: np.ndarray):
        # with coarse_hw (include_normals off) the analytic render happens
        # directly at the integration shape, as the real normal net's
        # coarse output does
        H, W = self.coarse_hw or img01.shape[:2]
        if self._K is None:
            raise RuntimeError("FakeNNET.observe(frame) must run before inference")
        Hn, Wn = self._native_hw
        K = self._K.copy()
        K[0] *= W / Wn
        K[1] *= H / Hn
        normals = self.scene.render(self._T, K, H, W)["normals"]
        kappa = np.full((H, W, 1), 10.0, np.float32)
        return normals, kappa


def _fake_lowres_logits(seeds, aniso, pts, t_vec, alpha: float, S: int, s: float):
    """(B, 3, S, S) Voronoi-margin logits and (B, 3) IoU predictions on the
    device of ``seeds``.

    For prompt b with Voronoi cell c = argmin_k d_k(p_b), the logit field is
    the signed margin f(x) = min_{j != c} d_j(x) - d_c(x) (anisotropic
    distances, input-frame pixels): positive inside the cell, about linear
    across the boundary, so thresholding at 0 gives the cell while the +-1
    stability band filters.  Candidates 1 and 2 shift the margin by
    ``t_vec`` (nested dilations, SAM's part/object/scene nesting).
    ``pts`` (B, 2) are the prompts' (x, y)."""
    qy = (pts[:, 1][:, None] - seeds[None, :, 0]) * aniso[None, :, 0]
    qx = (pts[:, 0][:, None] - seeds[None, :, 1]) * aniso[None, :, 1]
    cell = torch.argmin(qy * qy + qx * qx, dim=1)  # (B,)

    # low-res grid pixel centres in input-frame coordinates
    cc = (torch.arange(S, dtype=torch.float32, device=seeds.device) + 0.5) * s - 0.5
    gy = (cc[:, None] - seeds[None, :, 0]) * aniso[None, :, 0]  # (S, C)
    gx = (cc[:, None] - seeds[None, :, 1]) * aniso[None, :, 1]  # (S, C)
    d2 = gy[:, None, :] * gy[:, None, :] + gx[None, :, :] * gx[None, :, :]  # (S, S, C)
    m12, idx2 = torch.topk(d2, 2, dim=-1, largest=False)  # two smallest, ascending
    m1, m2, a1 = m12[..., 0], m12[..., 1], idx2[..., 0]

    d_own = d2.permute(2, 0, 1)[cell]  # (B, S, S)
    d_other = torch.where(a1[None] == cell[:, None, None], m2[None], m1[None])
    f = sqrt_rn(d_other) - sqrt_rn(d_own)
    logits = (f[:, None] + t_vec[None, :, None, None]) * alpha
    iou = torch.tensor([0.88, 0.97, 0.92], dtype=torch.float32,
                       device=seeds.device).expand(pts.shape[0], 3)
    return logits, iou


class DeviceFakeSAM(PromptRounds):
    """Voronoi fake masks through the device selection path.

    Only the decode is fake: :func:`_fake_lowres_logits` stands in for the
    SAM encoder and mask decoder, and everything after it (K3 statistics,
    smallest-good selection, box NMS, packed survivors, DeferredMasks) is
    the predictor's own code (``nets/sam/predictor.py``)."""

    lowres_size = 256  # SAM decoder's low-res logit grid

    def __init__(self, n_cells: int = 48, seed: int = 0,
                 dilate_px: tuple[float, float] = (8.0, 24.0),
                 edge_sharpness: float = 1.0, target_length: int = 1024,
                 device: str | torch.device = "cuda"):
        self.n_cells = n_cells
        self.seed = seed
        self.target_length = target_length
        self.device = torch.device(device)
        self._t_vec = torch.tensor([0.0, *dilate_px], dtype=torch.float32, device=self.device)
        self._alpha = float(np.float32(edge_sharpness))
        self._features = None
        self._input_hw = None
        self._cache: dict[tuple[int, int], tuple] = {}

    def _decode(self, pts):
        seeds, aniso = self._features
        S = self.lowres_size
        return _fake_lowres_logits(seeds, aniso, pts, self._t_vec, self._alpha, S,
                                   self.target_length / S)

    def _decode_stats(self, pts, input_hw, out_size):
        lowres, iou = self._decode(pts)
        return stats_from_lowres(lowres, iou, input_hw, out_size, self.target_length)

    def _decode_select(self, pts, input_hw, out_size, iou_thr, stab_thr):
        lowres, iou = self._decode(pts)
        return select_from_lowres(lowres, iou, input_hw, out_size, iou_thr, stab_thr,
                                  self.target_length)

    def set_image(self, image_hwc_uint8: np.ndarray):
        H, W = image_hwc_uint8.shape[:2]
        h2, w2 = get_preprocess_shape(H, W, self.target_length)
        if (H, W) not in self._cache:
            # seeds drawn in image coordinates (as the host FakeSAM draws
            # them), expressed in input-frame pixels
            r = np.random.default_rng(self.seed)
            seeds = np.stack(
                [r.uniform(0, H, self.n_cells), r.uniform(0, W, self.n_cells)], axis=1,
            ) * (h2 / H)
            aniso = r.uniform(0.6, 1.6, (self.n_cells, 2))
            self._cache[(H, W)] = tuple(
                torch.as_tensor(a.astype(np.float32), device=self.device) for a in (seeds, aniso))
        self._features = self._cache[(H, W)]
        self._input_hw = (h2, w2)


class StructuredFakeFrontend(FrontProcessor):
    """The real FrontProcessor running on structured fakes, on ``device``.

    ``device_sam=True`` swaps the host FakeSAM for :class:`DeviceFakeSAM`
    wired through ``wire_mask_predictor``: the device selection path with
    K3, box NMS and packed survivors feeding BiNI.  Implements the runner's
    ``observe(frame)`` hook to feed the frame pose to FakeNNET.
    """

    def __init__(self, config: Config, scene=None, seed: int = 0,
                 n_cells: int = 48, device: str | torch.device = "cuda",
                 device_sam: bool = False):
        if scene is None:
            from ..data.synthetic import PlanesScene

            scene = PlanesScene()
        self.scene = scene
        coarse = (
            None if config.frontend.include_normals
            else tuple(config.frontend.normals.integration_shape)
        )
        self._fake_nnet = FakeNNET(scene, coarse_hw=coarse)
        if device_sam:
            mask_fn = wire_mask_predictor(DeviceFakeSAM(n_cells=n_cells, seed=seed,
                                                        device=device))
        else:
            mask_fn = FakeSAM(n_cells=n_cells, seed=seed)
        super().__init__(
            config,
            normals_fn=self._fake_nnet,
            mask_predict_fn=mask_fn,
            rng=np.random.default_rng(42 + seed),
            device=device,
        )

    def observe(self, frame: dict):
        img = np.asarray(frame["image"])
        self._fake_nnet.observe(
            np.asarray(frame["T"]), np.asarray(frame["intrinsics"]),
            img.shape[:2],
        )
