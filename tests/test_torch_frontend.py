"""The keyframe frontend of the PyTorch port against the JAX package.

- The numpy resizes that replace OpenCV equal ``cv2.resize``: exactly for
  nearest and for uint8 bilinear, to 1e-6 for float32 bilinear.
- Mask generation pieces equal the JAX package's (edge maps to 1e-6).
- ``FrontProcessor`` on the structured fakes at 96x128: the port's BiNI
  schedule (each SAM round's segments unpadded, one batch per crop bucket)
  against the JAX package's padded batches gives identical regions and
  keypoints and log-depths within 1e-3.
"""

import cv2
import numpy as np
import pytest
import torch

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.data.synthetic import PlanesSequence as JPlanes
from super_primitive_tpu.frontend import mask_generation as jmg
from super_primitive_tpu.frontend import process_frame as jpf
from super_primitive_tpu.frontend.fakes import FakeSAM as JFakeSAM
from super_primitive_tpu.frontend.fakes import StructuredFakeFrontend as JFrontend
from super_primitive_tpu.frontend.stub import GridSegmentFrontend as JGrid
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.data.synthetic import PlanesSequence as TPlanes
from super_primitive_tpu_torch.frontend import mask_generation as tmg
from super_primitive_tpu_torch.frontend import process_frame as tpf
from super_primitive_tpu_torch.frontend.fakes import FakeSAM as TFakeSAM
from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend as TFrontend
from super_primitive_tpu_torch.frontend.stub import GridSegmentFrontend as TGrid

RESIZES = [
    ((480, 640), (240, 320)),   # the slice's SAM and keyframe downsample
    ((96, 128), (96, 128)),     # identity
    ((240, 320), (480, 640)),   # 2x up
    ((100, 130), (37, 51)),
    ((97, 131), (240, 320)),
    ((96, 128), (48, 64)),
]


class TestResize:
    @pytest.mark.parametrize("src,dst", RESIZES)
    def test_linear_uint8_exact(self, src, dst):
        x = np.random.default_rng(0).integers(0, 256, src + (3,)).astype(np.uint8)
        ref = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(tpf.linear_resize(x, dst), ref)

    @pytest.mark.parametrize("src,dst", RESIZES)
    def test_linear_float(self, src, dst):
        x = np.random.default_rng(1).uniform(0, 1, src + (3,)).astype(np.float32)
        ref = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
        out = tpf.linear_resize(x, dst)
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)

    @pytest.mark.parametrize("src,dst", RESIZES + [((240, 320), (96, 128))])
    def test_nearest_exact(self, src, dst):
        r = np.random.default_rng(2)
        img = r.uniform(0, 1, src + (3,)).astype(np.float32)
        assert np.array_equal(tpf.nn_resize(img, dst),
                              cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))
        masks = r.uniform(size=(5,) + src) > 0.5
        ref = np.stack([cv2.resize(m.astype(np.uint8), dst[::-1],
                                   interpolation=cv2.INTER_NEAREST) for m in masks])
        assert np.array_equal(tpf.nn_resize(masks, dst), ref.astype(bool))
        assert np.array_equal(tpf.nn_resize(masks, dst), jpf._nn_resize(masks, dst))


class TestMaskGeneration:
    @pytest.fixture(scope="class")
    def logits(self):
        sam = JFakeSAM(n_cells=12, seed=1)
        kps = np.random.default_rng(3).uniform(-1, 1, (20, 2)).astype(np.float32)
        return sam(np.zeros((48, 64, 3), np.uint8), kps)

    def test_fake_sam_equal(self, logits):
        kps = np.random.default_rng(3).uniform(-1, 1, (20, 2)).astype(np.float32)
        lt, it = TFakeSAM(n_cells=12, seed=1)(np.zeros((48, 64, 3), np.uint8), kps)
        assert np.array_equal(lt, logits[0]) and np.array_equal(it, logits[1])

    @pytest.mark.parametrize("select_smallest", [True, False])
    def test_selection_and_nms(self, logits, select_smallest):
        a = tmg.smallest_good_mask_batch(*logits, select_smallest=select_smallest)
        b = jmg.smallest_good_mask_batch(*logits, select_smallest=select_smallest)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        assert np.array_equal(tmg.nms(a["boxes"], a["iou_preds"], 0.5),
                              jmg.nms(b["boxes"], b["iou_preds"], 0.5))
        assert np.array_equal(tmg.calculate_stability_score(logits[0], 0.0, 1.0),
                              jmg.calculate_stability_score(logits[0], 0.0, 1.0))

    def test_active_sampling_same_draws(self, logits):
        cov = logits[0][:, 0].max(axis=0) > 0
        a = tmg.active_sample_pos(cov, 16, np.random.default_rng(4))
        b = jmg.active_sample_pos(cov, 16, np.random.default_rng(4))
        assert np.array_equal(a, b)

    def test_edges(self, logits):
        masks = logits[0][:, 0] > 0
        np.testing.assert_allclose(tmg.masks_to_edges(masks, "cpu"),
                                   jmg.masks_to_edges(masks), atol=1e-6, rtol=0)
        for a, b in zip(tmg.infer_edge_probs_coarse(masks, (24, 32), "cpu"),
                        jmg.infer_edge_probs_coarse(masks, (24, 32))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def frontend_cfg(load_config):
    return load_config({
        "save_path": "unused",
        "frontend": {
            "downsample_pow": 0, "num_pts": 48, "num_pts_active": 16,
            "normals": {"integration_shape": [48, 64], "network_dim": [96, 128]},
            "cg_max_iter": 150, "cg_tol": 1e-3, "check_for_depth_disc": False,
        },
        "sam_params": {"infer_resolution": [96, 128]},
    })


@pytest.fixture(scope="module")
def keyframes():
    seq = JPlanes(n_frames=2, H=96, W=128)
    f0, f1 = seq[0], seq[1]
    out = {}
    for name, cls, load in (("jax", JFrontend, jload_config), ("torch", TFrontend, tload_config)):
        kw = {} if name == "jax" else {"device": "cpu"}
        fe = cls(frontend_cfg(load), seed=0, n_cells=24, **kw)
        fe.observe(f0)
        out[name] = (fe.process_to_kf(f0["image"], f0["intrinsics"]),
                     fe.process_to_supp_kf(f1["image"], f1["intrinsics"]))
    return out


class TestFrontProcessor:
    def test_regions_and_keypoints_identical(self, keyframes):
        kt, kj = keyframes["torch"][0], keyframes["jax"][0]
        assert kt["regions"].shape[0] > 10
        assert np.array_equal(kt["regions"], kj["regions"])
        assert np.array_equal(kt["keypoints_rc"], kj["keypoints_rc"])
        np.testing.assert_array_equal(kt["K"], kj["K"])

    def test_logdepth_and_images(self, keyframes):
        (kt, st), (kj, sj) = keyframes["torch"], keyframes["jax"]
        np.testing.assert_allclose(kt["logdepth_perseg"], kj["logdepth_perseg"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(kt["image"], kj["image"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(st["image"], sj["image"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(st["K"], sj["K"])
        np.testing.assert_allclose(kt["edges"], kj["edges"], atol=1e-6, rtol=0)

    def test_single_bucket_matches_routing(self, keyframes):
        """Every crop bucket solves a segment exactly when its bbox fits, so
        forcing the full field changes nothing beyond CG tolerance."""
        fe = TFrontend(frontend_cfg(tload_config), seed=0, n_cells=24, device="cpu")
        f0 = JPlanes(n_frames=1, H=96, W=128)[0]
        fe.observe(f0)
        normals, _ = fe.normals_fn(f0["image"])
        masks = tpf.nn_resize(keyframes["torch"][0]["regions"][:4], (48, 64))
        K = tpf.scale_K(f0["intrinsics"], 0.5, 0.5)
        from super_primitive_tpu_torch.integrate.bini import BiniConfig

        cfg = BiniConfig(outer_iters=2, cg_max_iter=150)
        routed = fe.integrate(normals, masks, K, cfg)
        full = fe.integrate(normals, masks, K, cfg, crop=10**6)
        np.testing.assert_allclose(np.log(routed[masks]), np.log(full[masks]), atol=1e-3)


class TestDataAndStub:
    def test_planes_sequence(self):
        a, b = TPlanes(n_frames=4, H=24, W=32), JPlanes(n_frames=4, H=24, W=32)
        for i in range(4):
            np.testing.assert_allclose(a.poses[i], b.poses[i], atol=1e-6)
            np.testing.assert_allclose(a[i]["image"], b[i]["image"], atol=1e-5)

    def test_grid_stub(self):
        f = JPlanes(n_frames=1, H=48, W=64)[0]
        out = []
        for cls in (TGrid, JGrid):
            fe = cls(rows=3, cols=4, downsample_pow=1)
            fe.observe(f)
            out.append(fe.process_to_kf(f["image"], f["intrinsics"]))
        for k in out[0]:
            assert np.array_equal(out[0][k], out[1][k]), k
