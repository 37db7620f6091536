"""SAM's input frame made in one pass (``ops/sam_frame.py``, kernel
``csrc/sam_frame.cu``) against the two ``image/resize.linear_resize`` calls
it replaces.

- the wrapper's CPU path is the two calls, byte for byte, at the keyframe's
  shapes, the copy, the exact 2x reduction and odd ratios;
- an emulation of the kernel's composed int32 arithmetic on the tap tables
  the kernel gets gives the same bytes on random and extreme frames, so the
  kernel's design is held here, where no card is;
- on the tiny SAM on the CPU, a frame from ``SamPredictor.prepare_frame``
  encodes to the same features and gives the same selections, statistics
  and full-resolution logits as ``set_image`` of the host-resized frame;
- on a card (``cuda`` marker; run with ``python -m pytest
  tests/test_torch_sam_frame.py -m cuda``), the kernel against the plain
  version byte for byte, and frames prepared back to back through the
  predictor's one pinned buffer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from super_primitive_tpu_torch.config import load_config
from super_primitive_tpu_torch.frontend import mask_generation
from super_primitive_tpu_torch.frontend.process_frame import wire_mask_predictor
from super_primitive_tpu_torch.image.resize import ONE, linear_resize
from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_TINY_TEST
from super_primitive_tpu_torch.nets.sam.predictor import SamFrame, SamPredictor
from super_primitive_tpu_torch.nets.synth import synth_sam_state_dict
from super_primitive_tpu_torch.ops import sam_frame as sf

# (image, infer_resolution, SAM's input frame)
SHAPES = {
    "keyframe": ((480, 640), (960, 1280), (768, 1024)),
    "copy": ((48, 64), (48, 64), (48, 64)),
    "half": ((96, 128), (48, 64), (24, 32)),
    "odd_up": ((97, 131), (200, 260), (150, 197)),
    "odd_down": ((300, 400), (150, 200), (77, 103)),
    "one_axis": ((60, 80), (60, 100), (51, 85)),
}


def frame(hw, seed, kind="random") -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)
    return np.full((*hw, 3), 255 if kind == "white" else 0, np.uint8)


def two_resizes(img, mid_hw, out_hw) -> np.ndarray:
    return linear_resize(linear_resize(img, mid_hw), out_hw)


def vertical(hor0, hor1, b):
    v = ((((hor0 >> 4) * b) >> 16) + (((hor1 >> 4) * (ONE - b)) >> 16) + 2) >> 2
    return np.clip(v, 0, 255)


def kernel_emulation(img: np.ndarray, tables: np.ndarray, mid_hw, out_hw) -> np.ndarray:
    """csrc/sam_frame.cu in int32 numpy: each output pixel's stage-2 taps
    over the four intermediate pixels it needs, each formed from four image
    pixels with the stage-1 taps; nothing at the intermediate size is made
    but those pixels."""
    assert tables.dtype == np.int32
    (h1, w1), (h2, w2) = mid_hw, out_hw
    sizes = (h1,) * 3 + (w1,) * 3 + (h2,) * 3 + (w2,) * 3
    sy0, sy1, ay, sx0, sx1, ax, ry0, ry1, by, rx0, rx1, bx = np.split(
        tables, np.cumsum(sizes)[:-1])
    x = img.astype(np.int32)

    def mid(r, c):  # the intermediate pixel (r, c), r (h2, 1), c (1, w2)
        a, b = ax[c][..., None], ay[r][..., None]
        hor0 = x[sy0[r], sx0[c]] * a + x[sy0[r], sx1[c]] * (ONE - a)
        hor1 = x[sy1[r], sx0[c]] * a + x[sy1[r], sx1[c]] * (ONE - a)
        assert hor0.dtype == np.int32 and max(hor0.max(), hor1.max()) <= 255 * ONE
        return vertical(hor0, hor1, b)

    r0, r1, c0, c1 = ry0[:, None], ry1[:, None], rx0[None, :], rx1[None, :]
    a, b = bx[None, :, None], by[:, None, None]
    hor0 = mid(r0, c0) * a + mid(r0, c1) * (ONE - a)
    hor1 = mid(r1, c0) * a + mid(r1, c1) * (ONE - a)
    out = vertical(hor0, hor1, b)
    assert out.dtype == np.int32
    return out.astype(np.uint8)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_cpu_path_is_the_two_resizes(case):
    src_hw, mid_hw, out_hw = SHAPES[case]
    img = frame(src_hw, 1)
    sf.reset_launch_counts()
    got = sf.sam_frame(torch.from_numpy(img), mid_hw, out_hw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*out_hw, 3)
    np.testing.assert_array_equal(got.numpy(), two_resizes(img, mid_hw, out_hw))
    assert sf.launch_counts["sam_frame"] == 0  # the plain version launches nothing


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_kernel_arithmetic_on_its_tables(case):
    src_hw, mid_hw, out_hw = SHAPES[case]
    tables = sf.tap_tables(src_hw, mid_hw, out_hw)
    assert tables.size == 3 * (sum(mid_hw) + sum(out_hw))
    for seed, kind in ((2, "random"), (3, "random"), (0, "white"), (0, "black")):
        img = frame(src_hw, seed, kind)
        np.testing.assert_array_equal(kernel_emulation(img, tables, mid_hw, out_hw),
                                      two_resizes(img, mid_hw, out_hw), err_msg=kind)


def test_tap_tables_stay_in_range():
    for src_hw, mid_hw, out_hw in SHAPES.values():
        t = sf.tap_tables(src_hw, mid_hw, out_hw)
        (h1, w1), (h2, w2) = mid_hw, out_hw
        for n, extent, lo in ((h1, src_hw[0], 0), (w1, src_hw[1], 3 * h1),
                              (h2, h1, 3 * (h1 + w1)), (w2, w1, 3 * (h1 + w1) + 3 * h2)):
            s0, s1, a0 = t[lo:lo + n], t[lo + n:lo + 2 * n], t[lo + 2 * n:lo + 3 * n]
            assert 0 <= s0.min() and max(s0.max(), s1.max()) < extent
            assert 0 <= a0.min() and a0.max() <= ONE


@pytest.fixture(scope="module")
def tiny_predictors():
    """Two tiny SAM predictors on the CPU with the same weights: one sets
    host-resized frames, one prepared ones."""
    sd = synth_sam_state_dict(VIT_TINY_TEST)
    return (SamPredictor(sd, VIT_TINY_TEST, device="cpu"),
            SamPredictor(sd, VIT_TINY_TEST, device="cpu"))


def test_prepared_frame_encodes_as_the_host_frame(tiny_predictors):
    host, card = tiny_predictors
    image, infer_hw = frame((40, 56), 4), (60, 84)
    host.set_image(linear_resize(image, infer_hw))
    sam_img = card.prepare_frame(image, infer_hw)
    assert isinstance(sam_img, SamFrame) and sam_img.shape == (60, 84, 3)
    assert not sam_img.pixels.is_cuda
    card.set_image(sam_img)
    assert torch.equal(card._features, host._features)
    assert card._input_hw == host._input_hw == (46, 64)
    assert card._orig_hw == host._orig_hw == infer_hw
    feats = card._features
    card.set_image(sam_img)  # the same frame encodes once
    assert card._features is feats
    card.set_image(frame((40, 56), 5))
    card.set_image(sam_img)  # and again after another image
    assert torch.equal(card._features, feats) and card._input_hw == (46, 64)
    flipped = card.prepare_frame(image[:, ::-1], infer_hw)  # any strides
    np.testing.assert_array_equal(flipped.pixels.numpy(),
                                  two_resizes(image[:, ::-1], infer_hw, (46, 64)))
    for bad in (image.astype(np.float32) / 255, image[..., 0], image[..., :2]):
        with pytest.raises(ValueError, match="uint8 image"):
            card.prepare_frame(bad, infer_hw)


def test_prepared_frame_gives_the_same_masks(tiny_predictors):
    """The mask generation's two rounds on the device selection path, the
    loose statistics path and the full-resolution logits of the loose
    rerun, from a prepared frame and from the host-resized one."""
    host, card = tiny_predictors
    image, infer_hw = frame((48, 64), 6), (72, 96)
    host_img = linear_resize(image, infer_hw)
    sam_params = load_config({"sam_params": {"stability_threshold": 0.0,
                                             "iou_threshold": -1e9}}).sam_params
    for loose in (False, True):
        params = (dataclasses.replace(sam_params, nms=False, select_smallest=False)
                  if loose else sam_params)
        out = []
        for predictor, img in ((host, host_img), (card, card.prepare_frame(image, infer_hw))):
            out.append(mask_generation.infer_masks(
                wire_mask_predictor(predictor), img, params, num_pts=24, num_pts_active=8,
                rng=np.random.default_rng(7), edge_probs_shape=(24, 32), device="cpu"))
        a, b = out
        assert len(a["masks"]) > 0
        for k in ("masks", "iou_preds", "keypoints", "src_round", "src_idx", "edges"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k}, loose={loose}")
    pts = np.asarray([[3.0, 5.0], [40.0, 30.0], [63.0, 45.0]], np.float32)
    (m_host, iou_host), (m_card, iou_card) = (p.predict_batched_points(pts) for p in (host, card))
    assert m_host.shape == (3, 3, *infer_hw)
    np.testing.assert_array_equal(m_host, m_card)
    np.testing.assert_array_equal(iou_host, iou_card)


@pytest.mark.cuda
class TestKernelOnCard:
    """Run with ``python -m pytest tests/test_torch_sam_frame.py -m cuda``
    on a machine with a card; skips elsewhere."""

    @pytest.mark.parametrize("case", sorted(SHAPES))
    def test_kernel_matches_plain_version(self, case):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        src_hw, mid_hw, out_hw = SHAPES[case]
        for seed, kind in ((8, "random"), (9, "random"), (0, "white"), (0, "black")):
            img = torch.from_numpy(frame(src_hw, seed, kind))
            before = sf.launch_counts["sam_frame"]
            got = sf.sam_frame(img.cuda(), mid_hw, out_hw)
            assert sf.launch_counts["sam_frame"] == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), sf.sam_frame_reference(img, mid_hw, out_hw)), kind

    def test_kernel_refuses_what_it_does_not_take(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        img = torch.zeros((40, 60, 3), dtype=torch.uint8, device="cuda")
        for bad in (img.float(), img[:, :, :2].contiguous(), img.transpose(0, 1)):
            with pytest.raises(ValueError):
                sf.sam_frame(bad, (40, 60), (32, 48))

    def test_frames_prepared_back_to_back(self):
        """Frames prepared one after another without a synchronise each
        keep their own image's bytes: the pinned buffer is written again
        only after its last copy."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        predictor = SamPredictor(synth_sam_state_dict(VIT_TINY_TEST), VIT_TINY_TEST,
                                 device="cuda")
        images = [frame((480, 640), seed) for seed in range(10, 16)]
        frames = [predictor.prepare_frame(img, (960, 1280)) for img in images]
        for img, f in zip(images, frames):
            assert f.pixels.is_cuda and f.shape == (960, 1280, 3)
            np.testing.assert_array_equal(f.pixels.cpu().numpy(),
                                          two_resizes(img, (960, 1280), (48, 64)))
