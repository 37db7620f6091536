"""The SAM predictor's full-resolution paths in the PyTorch port against the
JAX package (CPU, float32): ``image/resize.resize_bilinear`` against
``jax.image.resize(..., "bilinear")``, ``postprocess_masks``,
``predict_batched_points``, and the statistics and the selection at
``out_size != S``.

Bounds:
- the resize within 1e-5 absolute at the predictor's own shapes (256² ->
  1024² up, the 768x1024 crop -> 480x640 down, 256² -> 512²), on logits
  of magnitude ~20;
- logits after a resize within ``DEC_BOUND`` (``test_torch_nets_sam.py``'s
  decoder bound, relative to the largest) plus 1e-5; masks thresholded
  after a resize equal except where JAX's |logit| is below that tolerance
  (a flip there is an ulp-level tie, not a fault); K3's counts (the plain
  version here: stability and area) exact, on prompts whose low-res
  interpolants all stay 1e-4 away from the thresholds (on the raw std-1
  synthetic weights, whose logits jump between pixels; there the decoder's
  bound is ``RAW_BOUND``);
- ``stats_from_lowres`` / ``select_from_lowres`` on the same low-res logits
  in both packages: everything exact (the 2x and 4x upsamples are exact);
- the card's K3 on the out_size != S path against its plain version,
  exactly (``cuda`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.nets import convert as jconvert
from super_primitive_tpu.nets.sam import image_encoder as jie
from super_primitive_tpu.nets.sam import predictor as jpm
from super_primitive_tpu.nets.sam.predictor import SamPredictor as JPredictor
from super_primitive_tpu.nets.synth import synth_sam_state_dict as j_synth
from super_primitive_tpu_torch.image.resize import resize_bilinear
from super_primitive_tpu_torch.nets import synth as tsynth
from super_primitive_tpu_torch.nets.sam import image_encoder as tie
from super_primitive_tpu_torch.nets.sam import predictor as tpm
from super_primitive_tpu_torch.nets.sam.predictor import SamPredictor as TPredictor
from super_primitive_tpu_torch.ops import phase_counts as k3

DEC_BOUND, RAW_BOUND = 4.0e-6, 3e-5
RESIZE_TOL = 1e-5
IMAGE_HW = (48, 60)  # input frame (51, 64) of the tiny 64-pixel SAM


@pytest.mark.parametrize("in_hw, out_hw", [((256, 256), (1024, 1024)),
                                           ((768, 1024), (480, 640)),
                                           ((256, 256), (512, 512))])
def test_resize_matches_jax(in_hw, out_hw):
    x = (np.random.default_rng(0).normal(size=(2, *in_hw)) * 5).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x)[..., None], (2, *out_hw, 1), "bilinear")[..., 0]
    got = resize_bilinear(torch.from_numpy(x), out_hw)
    assert got.shape == (2, *out_hw) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESIZE_TOL)


def make_predictors(weights):
    """The JAX and port predictors on the same tiny SAM (oracle-scaled or
    raw synthetic weights), with the same non-square image set."""
    sd = j_synth(jie.VIT_TINY_TEST)
    sd = tsynth.scale_like_trained(sd) if weights == "scaled" else sd
    tree = jax.tree.map(jnp.asarray, jconvert.convert_sam(sd, depth=jie.VIT_TINY_TEST.depth))
    jp, tp = JPredictor(tree, jie.VIT_TINY_TEST), TPredictor(sd, tie.VIT_TINY_TEST, device="cpu")
    image = np.random.default_rng(5).integers(0, 255, (*IMAGE_HW, 3), np.uint8)
    jp.set_image(image)
    tp.set_image(image)
    assert tp._orig_hw == jp._orig_hw == IMAGE_HW
    return jp, tp


@pytest.fixture(scope="module")
def predictors():
    return make_predictors("scaled")


@pytest.fixture(scope="module")
def raw_predictors():
    return make_predictors("raw")


def tolerance(want, bound=DEC_BOUND) -> float:
    return bound * float(np.abs(want).max()) + RESIZE_TOL


def assert_masks_equal_off_ties(got_bool, want_bool, want_logits, tol):
    """Equal wherever JAX's logit is at least ``tol`` from the threshold."""
    firm = np.abs(want_logits) >= tol
    np.testing.assert_array_equal(got_bool[firm], want_bool[firm])
    assert firm.mean() > 0.99


def test_postprocess_masks(predictors):
    jp, tp = predictors
    lowres = (np.random.default_rng(1).normal(size=(3, 3, 16, 16)) * 4).astype(np.float32)
    want = np.asarray(jp.postprocess_masks(jnp.asarray(lowres)))
    got = tp.postprocess_masks(torch.from_numpy(lowres)).numpy()
    assert got.shape == want.shape == (3, 3, *IMAGE_HW)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


def test_predict_batched_points(predictors):
    """70 prompts: a full chunk of 64 and a padded one."""
    jp, tp = predictors
    pts = (np.random.default_rng(2).random((70, 2)) * [63.0, 50.0]).round().astype(np.float32)
    want_m, want_i = jp.predict_batched_points(pts)
    got_m, got_i = tp.predict_batched_points(pts)
    assert got_m.shape == want_m.shape == (70, 3, *IMAGE_HW) and got_i.shape == (70, 3)
    tol = tolerance(want_m)
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=tol)
    np.testing.assert_allclose(got_i, want_i, rtol=0, atol=DEC_BOUND * np.abs(want_i).max())
    assert_masks_equal_off_ties(got_m > 0, want_m > 0, want_m, tol)
    # chunking changes nothing: one prompt alone decodes as in the batch
    alone_m, alone_i = tp.predict_batched_points(pts[66:67], chunk=1)
    np.testing.assert_allclose(alone_m[0], got_m[66], rtol=0, atol=tol)


def firm_prompts(tp, n, seed):
    """Prompts whose upsampled low-res interpolants all stay 1e-4 away
    from the thresholds -1, 0 and 1 (so K3's counts cannot flip between
    the packages' last-ulp differences)."""
    r = np.random.default_rng(seed)
    pts = (r.random((n, 2)) * [63.0, 50.0]).round().astype(np.float32)
    lowres = tp._decode(torch.from_numpy(pts))[0][:, 1:].double()
    up = torch.nn.functional.interpolate(lowres, scale_factor=4, mode="bilinear")[:, :, :51, :64]
    firm = torch.ones(n, dtype=torch.bool)
    for t in (-1.0, 0.0, 1.0):
        firm &= ((up - t).abs().amin(dim=(1, 2, 3)) > 1e-4)
        firm &= ((lowres - t).abs().amin(dim=(1, 2, 3)) > 1e-4)
    assert int(firm.sum()) >= n // 2
    return pts[firm.numpy()]


@pytest.mark.parametrize("out_size", [32, 64])
def test_stats_at_out_size_other_than_lowres(raw_predictors, out_size):
    jp, tp = raw_predictors
    pts = firm_prompts(tp, 24, seed=3)
    want = jp.predict_points_with_stats(pts, out_size=out_size)
    got = tp.predict_points_with_stats(pts, out_size=out_size)
    hs, ws = round(51 * out_size / 64), round(64 * out_size / 64)
    assert got[0].shape == want[0].shape == (len(pts), 3, hs, ws)
    np.testing.assert_array_equal(got[2], want[2])  # stability: K3's counts
    np.testing.assert_array_equal(got[3], want[3])  # area
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=RAW_BOUND * np.abs(want[1]).max())
    lowres = tp._decode(torch.from_numpy(pts))[0][:, 1:]
    logits = resize_bilinear(lowres.reshape(-1, 16, 16), (out_size, out_size))
    logits = logits.reshape(len(pts), 3, out_size, out_size)[..., :hs, :ws].numpy()
    assert_masks_equal_off_ties(got[0], want[0], logits, tolerance(logits, RAW_BOUND))


@pytest.mark.parametrize("out_size", [32, 64])
def test_select_at_out_size_other_than_lowres(raw_predictors, out_size):
    jp, tp = raw_predictors
    pts = firm_prompts(tp, 24, seed=4)
    kw = dict(iou_threshold=0.0, stability_threshold=0.5, nms_enabled=True,
              box_nms_thresh=0.8, filter_by_box_size=True, out_size=out_size)
    want = jp.predict_points_select(pts, **kw)
    got = tp.predict_points_select(pts, **kw)
    assert got["keypoints_ids"].size > 0
    for k in ("keypoints_ids", "masks_ids", "boxes", "masks"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["iou_preds"], want["iou_preds"], rtol=RAW_BOUND)


@pytest.mark.parametrize("out_size", [128, 256])
def test_lowres_functions_at_out_size_other_than_lowres(out_size):
    """The statistics and the selection on the same (B, 3, 64, 64) logits
    (s = 4) in both packages, exactly."""
    r = np.random.default_rng(8)
    lowres = (r.normal(size=(12, 3, 64, 64)) * 3).astype(np.float32)
    iou = r.uniform(size=(12, 3)).astype(np.float32)
    hw = (192, 256)
    got = tpm.stats_from_lowres(torch.from_numpy(lowres), torch.from_numpy(iou), hw, out_size,
                                256)
    want = jpm.stats_from_lowres(jnp.asarray(lowres), jnp.asarray(iou), jnp.asarray(hw),
                                 out_size, 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tpm.select_from_lowres(torch.from_numpy(lowres), torch.from_numpy(iou), hw, out_size,
                                 0.0, 0.5, 256)
    want = jpm.select_from_lowres(jnp.asarray(lowres), jnp.asarray(iou), jnp.asarray(hw),
                                  out_size, jnp.float32(0.0), jnp.float32(0.5), 256)
    for name, g, w in zip(("packed", "iou", "valid", "boxes", "pick"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.cuda
def test_k3_on_the_card_at_out_size_other_than_lowres():
    """Run with ``python -m pytest tests/test_torch_sam_fullres.py -m cuda``
    on a machine with a card: the selection at out_size = 2S on the card,
    K3 against its plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = np.random.default_rng(7)
    lowres = torch.from_numpy((r.normal(size=(40, 3, 64, 64)) * 3).astype(np.float32)).cuda()
    iou = torch.from_numpy(r.uniform(size=(40, 3)).astype(np.float32)).cuda()
    before = k3.launch_counts["phase_counts"]
    got = tpm.select_from_lowres(lowres, iou, (192, 256), 128, 0.0, 0.5, 256)
    assert k3.launch_counts["phase_counts"] == before + 1
    want = tpm.select_from_lowres(lowres.cpu(), iou.cpu(), (192, 256), 128, 0.0, 0.5, 256)
    for name, g, w in zip(("packed", "iou", "valid", "boxes", "pick"), got, want):
        assert torch.equal(g.cpu(), w), name
    counts = k3.phase_counts(lowres.reshape(-1, 64, 64), 4, (192, 256))
    for g, w in zip(counts, k3.phase_counts_reference(lowres.reshape(-1, 64, 64), 4, (192, 256))):
        assert torch.equal(g, w)
