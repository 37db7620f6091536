"""The depth-discontinuity split of the PyTorch port against the JAX package.

- ``label_components`` equals JAX's device labeller and its scipy labeller
  exactly on random masks (labels are component-minimum linear indices);
- ``depth_discontinuity`` equals JAX's exactly.  Near-threshold pixels: the
  magnitudes come from ``exp``, which PyTorch and XLA may round apart by an
  ulp, so exactness is asserted where no pixel's magnitude lies within 1e-5
  of the threshold (the random case checks that margin on the JAX side);
  piecewise-constant depths, whose magnitudes are far from it, are exact
  without that condition;
- ``split_disconnected_segments`` gives identical regions, log-depths and
  keypoints (the same generator draws), on a fake-frontend keyframe at
  96x128 and on the inherently disconnected segment of
  ``tests/test_ops_eval.py``;
- the frontend with the split on gives the JAX package's keyframe.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.data.synthetic import PlanesSequence as JPlanes
from super_primitive_tpu.frontend import post_process as jpost
from super_primitive_tpu.frontend.fakes import StructuredFakeFrontend as JFrontend
from super_primitive_tpu.image.gradients import scharr_gradients as j_scharr
from super_primitive_tpu.ops import connected_components as jcc
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.frontend import post_process as tpost
from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend as TFrontend
from super_primitive_tpu_torch.ops import connected_components as tcc


@pytest.mark.parametrize("density", [0.35, 0.55, 0.75])
def test_label_components(density):
    r = np.random.default_rng(int(100 * density))
    masks = r.uniform(size=(4, 37, 53)) < density
    masks[0] = False  # an empty mask
    got = tcc.label_components(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcc.label_components(jnp.asarray(masks))))
    np.testing.assert_array_equal(got, jcc._label_components_host(masks))
    assert got.dtype == np.int32 and (got[0] == -1).all()


def test_label_components_snake():
    """A winding one-pixel path needs many sweeps and the pointer jumps."""
    m = np.zeros((1, 21, 21), bool)
    m[0, ::4, :] = True
    for k, r in enumerate(range(0, 17, 4)):
        m[0, r : r + 5, 20 if k % 2 == 0 else 0] = True
    got = tcc.label_components(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, jcc._label_components_host(m))
    assert np.unique(got[m]).tolist() == [0]


def test_relabel_consecutive():
    lab = np.asarray([[-1, 7, 7], [30, -1, 30]], np.int32)
    for a, b in zip(tcc.relabel_consecutive_np(lab), jcc.relabel_consecutive_np(lab)):
        np.testing.assert_array_equal(a, b)


def disc_inputs(kind):
    r = np.random.default_rng(11)
    valid = r.uniform(size=(5, 40, 48)) > 0.3
    if kind == "random":
        ld = r.normal(0, 0.5, size=(5, 40, 48)).astype(np.float32)
    else:  # piecewise-constant depth steps
        ld = np.zeros((5, 40, 48), np.float32)
        ld[:, :, 20:] = np.log(3.0)
        ld[:, 25:] += np.float32(0.5)
    return ld, valid


@pytest.mark.parametrize("kind,k,thr", [("random", 3, 0.1), ("random", 5, 0.25),
                                        ("steps", 3, 0.1)])
def test_depth_discontinuity(kind, k, thr):
    ld, valid = disc_inputs(kind)
    got = tpost.depth_discontinuity(torch.from_numpy(ld), torch.from_numpy(valid), k, thr)
    want = np.asarray(jpost.depth_discontinuity(jnp.asarray(ld), jnp.asarray(valid), k, thr))
    # the margin of every magnitude to the threshold, on the JAX side
    depth = jnp.where(jnp.asarray(valid), jnp.exp(jnp.asarray(ld)), -1.0)
    gx, gy = j_scharr(jpost.max_pool2d_same(depth, k).transpose(1, 2, 0))
    margin = float(jnp.min(jnp.abs(jnp.sqrt(gx**2 + gy**2) - thr)))
    assert margin > 1e-5, margin
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_inherently_disconnected_no_disc():
    H, W = 240, 320
    regions = np.zeros((1, H, W), bool)
    regions[0, 10:60, 10:60] = True
    regions[0, 100:160, 100:160] = True
    logdepth = np.zeros((1, H, W), np.float32)
    kp = np.asarray([[30, 30]], np.int64)
    got = tpost.split_disconnected_segments(regions, logdepth, kp,
                                            rng=np.random.default_rng(0), device="cpu")
    want = jpost.split_disconnected_segments(regions, logdepth, kp, rng=np.random.default_rng(0))
    assert got[0].shape[0] == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_split_no_segments():
    """A keyframe whose every segment came out empty reaches the split with
    none; like JAX's, the split returns the empty stacks (it used to fail
    padding a zero-segment batch)."""
    regions = np.zeros((0, 24, 32), bool)
    logdepth = np.zeros((0, 24, 32), np.float32)
    kp = np.zeros((0, 2), np.int64)
    got = tpost.split_disconnected_segments(regions, logdepth, kp, device="cpu")
    want = jpost.split_disconnected_segments(regions, logdepth, kp)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype


def frontend_cfg(load_config, disc):
    return load_config({
        "save_path": "unused",
        "frontend": {
            "downsample_pow": 0, "num_pts": 64, "num_pts_active": 16,
            "normals": {"integration_shape": [48, 64], "network_dim": [96, 128]},
            "cg_max_iter": 150, "cg_tol": 1e-3, "check_for_depth_disc": disc,
        },
        "sam_params": {"infer_resolution": [96, 128]},
    })


@pytest.fixture(scope="module")
def keyframe():
    """A 96x128 keyframe of the port's frontend without the split."""
    f = JPlanes(n_frames=1, H=96, W=128)[0]
    fe = TFrontend(frontend_cfg(tload_config, False), n_cells=24, device="cpu")
    fe.observe(f)
    return fe.process_to_kf(f["image"], f["intrinsics"])


def test_split_keyframe(keyframe):
    args = (keyframe["regions"], keyframe["logdepth_perseg"], keyframe["keypoints_rc"],
            3, 0.1, 1e-3)
    got = tpost.split_disconnected_segments(*args, rng=np.random.default_rng(5), device="cpu")
    want = jpost.split_disconnected_segments(*args, rng=np.random.default_rng(5))
    assert got[0].shape[0] > keyframe["regions"].shape[0]  # something split
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_split_keyframe_in_chunks(keyframe, monkeypatch):
    """The split's device passes cut into chunks of 3 segments give the
    JAX package's output too."""
    args = (keyframe["regions"], keyframe["logdepth_perseg"], keyframe["keypoints_rc"],
            3, 0.1, 1e-3)
    monkeypatch.setattr(tpost, "SPLIT_CHUNK_PIXELS", 3 * 96 * 128 + 5)
    got = tpost.split_disconnected_segments(*args, rng=np.random.default_rng(5), device="cpu")
    want = jpost.split_disconnected_segments(*args, rng=np.random.default_rng(5))
    assert keyframe["regions"].shape[0] > 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_frontend_with_split():
    """Device SAM selection and the split on, port against JAX: the same
    regions and keypoints (the split's generator draws shift every later
    keypoint otherwise), log-depths within BiNI's CG tolerance."""
    f = JPlanes(n_frames=1, H=96, W=128)[0]
    out = []
    for cls, load, kw in ((TFrontend, tload_config, {"device": "cpu"}),
                          (JFrontend, jload_config, {})):
        fe = cls(frontend_cfg(load, True), n_cells=24, device_sam=True, **kw)
        fe.observe(f)
        kf = fe.process_to_kf(f["image"], f["intrinsics"])
        out.append((kf, fe.rng.integers(0, 2**31)))  # the generators end equal
    (a, ra), (b, rb) = out
    np.testing.assert_array_equal(a["regions"], b["regions"])
    np.testing.assert_array_equal(a["keypoints_rc"], b["keypoints_rc"])
    np.testing.assert_allclose(a["logdepth_perseg"], b["logdepth_perseg"], atol=1e-3, rtol=0)
    assert ra == rb
