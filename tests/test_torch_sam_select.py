"""The device SAM selection of the PyTorch port against the JAX package.

Everything here is exact (integer counts, bit-packed masks, boxes on the
integer grid, NMS decisions), so the comparisons are equality:

- ``select_from_lowres`` and ``stats_from_lowres`` on the JAX package's own
  fake low-res logits (S = 64, s = 4), the selection at out_size = 2S too;
- ``_select_nms_device``: kept set and coverage, both scoring modes;
- ``DeviceFakeSAM.predict_points_select`` at 96x128 with ``n_cells=24``:
  masks, iou_preds, keypoints_ids, boxes and masks_ids;
- the ``DeferredMasks`` products (``coverage``, ``device_masks_resized``,
  ``resized_bbox_sizes``, ``fetch``) and the statistics path;
- ``infer_masks`` through ``wire_mask_predictor``: the whole two-round
  generation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.frontend import mask_generation as jmg
from super_primitive_tpu.frontend import process_frame as jpf
from super_primitive_tpu.frontend.fakes import DeviceFakeSAM as JSam
from super_primitive_tpu.frontend.fakes import _fake_lowres_logits as j_fake
from super_primitive_tpu.nets.sam import predictor as jp
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.frontend import mask_generation as tmg
from super_primitive_tpu_torch.frontend import process_frame as tpf
from super_primitive_tpu_torch.frontend.fakes import DeviceFakeSAM as TSam
from super_primitive_tpu_torch.frontend.fakes import _fake_lowres_logits as t_fake
from super_primitive_tpu_torch.nets.sam import predictor as tp

S, TL = 64, 256                  # low-res grid, target length (s = 4)
INPUT_HW = (192, 256)


@pytest.fixture(scope="module")
def lowres():
    """(B, 3, S, S) fake logits and IoU from both packages on the same
    numpy seeds and prompts; the two must already agree exactly."""
    r = np.random.default_rng(0)
    seeds = np.stack([r.uniform(0, 192, 12), r.uniform(0, 256, 12)], 1).astype(np.float32)
    aniso = r.uniform(0.6, 1.6, (12, 2)).astype(np.float32)
    pts = np.round(r.uniform(0, 1, (20, 2)) * [255, 191]).astype(np.float32)
    t_vec = np.float32([0.0, 8.0, 24.0])
    jl, ji = j_fake(jnp.asarray(seeds), jnp.asarray(aniso),
                    jnp.asarray(np.stack([pts, 0 * pts], 1)), jnp.asarray(t_vec),
                    jnp.float32(1.0), S, TL / S)
    tl, ti = t_fake(torch.from_numpy(seeds), torch.from_numpy(aniso), torch.from_numpy(pts),
                    torch.from_numpy(t_vec), 1.0, S, TL / S)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    return tl, ti


@pytest.mark.parametrize("stab_thr", [0.0, 0.9])
def test_select_from_lowres(lowres, stab_thr):
    tl, ti = lowres
    got = tp.select_from_lowres(tl, ti, INPUT_HW, S, 0.0, stab_thr, TL)
    want = jp.select_from_lowres(jnp.asarray(tl.numpy()), jnp.asarray(ti.numpy()),
                                 jnp.asarray(INPUT_HW), S, jnp.float32(0.0),
                                 jnp.float32(stab_thr), TL)
    for name, g, w in zip(("packed", "iou", "valid", "boxes", "pick"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_stats_from_lowres(lowres):
    tl, ti = lowres
    got = tp.stats_from_lowres(tl, ti, INPUT_HW, S, TL)
    want = jp.stats_from_lowres(jnp.asarray(tl.numpy()), jnp.asarray(ti.numpy()),
                                jnp.asarray(INPUT_HW), S, TL)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_select_at_twice_lowres_equals_jax(lowres):
    """The selection at out_size = 2S, once refused, now resizes the picked
    logits as JAX does; the 2x upsample is exact, so everything is equal."""
    tl, ti = lowres
    got = tp.select_from_lowres(tl, ti, INPUT_HW, 2 * S, 0.0, 0.9, TL)
    want = jp.select_from_lowres(jnp.asarray(tl.numpy()), jnp.asarray(ti.numpy()),
                                 jnp.asarray(INPUT_HW), 2 * S, jnp.float32(0.0),
                                 jnp.float32(0.9), TL)
    for name, g, w in zip(("packed", "iou", "valid", "boxes", "pick"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("by_size", [True, False])
def test_select_nms_device(lowres, by_size):
    tl, ti = lowres
    packed, iou_pick, valid, boxes, _ = tp.select_from_lowres(tl, ti, INPUT_HW, S, 0.0, 0.0, TL)
    n = 17  # rows past n are padding and never compete
    kept, cov, _ = tp._select_nms_device(packed, iou_pick, valid, boxes, n, 0.5, by_size)
    jk, jc = jp._select_nms_device(*(jnp.asarray(t.numpy()) for t in (packed, iou_pick, valid, boxes)),
                                   jnp.int32(n), jnp.float32(0.5), by_size)
    assert kept.sum() >= 3
    np.testing.assert_array_equal(kept, np.asarray(jk))
    np.testing.assert_array_equal(cov.numpy(), np.asarray(jc))


def test_packbits_msb_first():
    m = np.random.default_rng(1).uniform(size=(3, 5, 24)) > 0.5
    packed = tp._packbits_lastaxis(torch.from_numpy(m))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(m, axis=-1))
    np.testing.assert_array_equal(tp._unpackbits_lastaxis(packed).numpy(), m)


@pytest.fixture(scope="module")
def sams():
    img = np.zeros((96, 128, 3), np.uint8)
    j, t = JSam(n_cells=24, seed=0), TSam(n_cells=24, seed=0, device="cpu")
    j.set_image(img)
    t.set_image(img)
    assert t._input_hw == j._input_hw == (768, 1024)
    kps = np.random.default_rng(2).uniform(-1, 1, (48, 2)).astype(np.float32)
    dims = np.asarray(t._input_hw, np.float32)
    xy = np.round((0.5 * (dims - 1) * (kps + 1))[:, ::-1])
    return j, t, xy


@pytest.mark.parametrize("by_size", [True, False])
def test_predict_points_select(sams, by_size):
    j, t, xy = sams
    kw = dict(stability_threshold=0.9, nms_enabled=True, box_nms_thresh=0.8,
              filter_by_box_size=by_size)
    a, b = t.predict_points_select(xy, **kw), j.predict_points_select(xy, **kw)
    assert len(a["keypoints_ids"]) >= 10
    for k in ("masks", "iou_preds", "keypoints_ids", "boxes", "masks_ids"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_deferred_products(sams):
    j, t, xy = sams
    ht = t.select_dispatch(xy, 0.0, 0.9)
    hj = j.select_dispatch(xy, 0.0, 0.9, nms_enabled=True, box_nms_thresh=0.8,
                           filter_by_box_size=False)
    a = t.select_finish(ht, box_nms_thresh=0.8, filter_by_box_size=False, defer_masks=True)
    b = j.select_finish(hj, box_nms_thresh=0.8, filter_by_box_size=False, defer_masks=True)
    dt, dj = a.pop("deferred"), b.pop("deferred")
    assert a["masks"] is None and dt.n_rows == dj.n_rows >= 10
    np.testing.assert_array_equal(a["coverage"], b["coverage"])
    np.testing.assert_array_equal(dt.coverage(), dj.coverage())
    np.testing.assert_array_equal(dt.fetch(), dj.fetch())
    for Hg, Wg in ((dt.hs, dt.ws), (240, 320), (197, 263)):
        rows = np.arange(dt.n_rows)[::2]
        np.testing.assert_array_equal(dt.device_masks_resized(rows, Hg, Wg).numpy(),
                                      np.asarray(dj.device_masks_resized(rows, rows.size, Hg, Wg)))
        for x, y in zip(dt.resized_bbox_sizes(Hg, Wg), dj.resized_bbox_sizes(Hg, Wg)):
            np.testing.assert_array_equal(x, y)


def test_stats_path(sams):
    j, t, xy = sams
    for x, y in zip(t.predict_points_with_stats(xy[:16]), j.predict_points_with_stats(xy[:16])):
        np.testing.assert_array_equal(x, y)


def test_infer_masks_device_selection(sams):
    """The whole two-round generation through wire_mask_predictor, with
    round 1 deferred on the device and the hook seeing its survivors."""
    j, t, _ = sams
    img = np.zeros((96, 128, 3), np.uint8)
    seen = {}
    out = {}
    for name, sam, wire, mg, load in (("torch", t, tpf.wire_mask_predictor, tmg, tload_config),
                                      ("jax", j, jpf.wire_mask_predictor, jmg, jload_config)):
        kw = {"device": "cpu"} if name == "torch" else {}
        out[name] = mg.infer_masks(
            wire(sam), img, load({}).sam_params, num_pts=48, num_pts_active=16,
            rng=np.random.default_rng(3), edge_probs_shape=(48, 64),
            on_round1=lambda m, name=name: seen.setdefault(name, m.n_rows), **kw)
    a, b = out["torch"], out["jax"]
    assert seen["torch"] == seen["jax"] > 0
    for k in ("masks", "keypoints", "src_round", "src_idx", "final_coverage", "coarse_coverage"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["edges"], b["edges"], atol=1e-6, rtol=0)


def test_sqrt_rn_correctly_rounded():
    """The fake margins and the split's magnitudes take their float32 square
    roots through ``sqrt_rn``: on the CPU PyTorch's own float32 sqrt is off
    by an ulp for some inputs, which flips threshold decisions against the
    JAX package."""
    from super_primitive_tpu_torch.utils.numerics import sqrt_rn

    x = np.random.default_rng(4).uniform(0, 1e5, 10**6).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))
