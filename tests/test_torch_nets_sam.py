"""The port's SAM networks against the JAX package's, on the CPU in float32,
with the same synthetic weights (``nets/synth.py``, published names) carried
across by the converters.

Bounds, relative to the reference's largest magnitude, on weights scaled
as the JAX package's oracle scales them (``scaled``,
``synth.scale_like_trained``: norm weights 1 + 0.1 w, the rest 0.05 w,
the Fourier matrix as it is): 3.5e-6 for the encoder (its blocks, the
whole encoder and ``set_image``'s features) and 4.0e-6 for the prompt
encoder and the mask decoder, the JAX package's own bounds against
transformers' torch SAM (README.md, "Offline torch oracles").  On the raw
std-1 synthetic weights the bound is ``RAW_BOUND``: there the attention
scores reach hundreds, the softmax saturates, and the ulp-level
differences of two summation orders in the scores come out relative ~1e-5
in the output (no formula differs).  The padded config's token grid (6x6)
does not divide by its window (4), so its windowed blocks pad to 8x8;
``VIT_TINY_TEST`` never pads.  The tanh GELU of the reduced-precision path
is held to JAX's ``gelu_approx`` in float32 at the same bounds, and the
bf16 predictor to the float32 one at ``BF16_BOUND``.  A selection round is
integer output and compares exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.nets import convert as jconvert
from super_primitive_tpu.nets.sam import image_encoder as jie
from super_primitive_tpu.nets.sam.mask_decoder import MaskDecoder as JDecoder
from super_primitive_tpu.nets.sam.predictor import SamPredictor as JPredictor
from super_primitive_tpu.nets.sam.prompt_encoder import PromptEncoder as JPromptEncoder
from super_primitive_tpu.nets.synth import synth_sam_state_dict as j_synth
from super_primitive_tpu_torch import convert as tconvert
from super_primitive_tpu_torch.nets import synth as tsynth
from super_primitive_tpu_torch.nets.sam import image_encoder as tie
from super_primitive_tpu_torch.nets.sam.predictor import SamPredictor as TPredictor
from super_primitive_tpu_torch.nets.sam.predictor import build_sam

ENC_BOUND, DEC_BOUND = 3.5e-6, 4.0e-6
RAW_BOUND = 3e-5
BF16_BOUND = 5e-2
PADDED = dict(img_size=96, window_size=4, depth=3, global_attn_indexes=(1,))
CONFIGS = {
    "tiny": (jie.VIT_TINY_TEST, tie.VIT_TINY_TEST),
    "padded": (dataclasses.replace(jie.VIT_TINY_TEST, **PADDED),
               dataclasses.replace(tie.VIT_TINY_TEST, **PADDED)),
}


def rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=[(c, w) for c in sorted(CONFIGS) for w in ("scaled", "raw")],
                ids=lambda p: "-".join(p))
def nets(request):
    """(config name, JAX config, port config, state dict, JAX tree as jnp,
    port Sam, (encoder bound, decoder bound))."""
    name, weights = request.param
    jcfg, tcfg = CONFIGS[name]
    sd = j_synth(jcfg)
    bounds = (RAW_BOUND, RAW_BOUND)
    if weights == "scaled":
        sd, bounds = tsynth.scale_like_trained(sd), (ENC_BOUND, DEC_BOUND)
    tree = jax.tree.map(jnp.asarray, jconvert.convert_sam(sd, depth=jcfg.depth))
    return name, jcfg, tcfg, sd, tree, build_sam(sd, tcfg, "cpu"), bounds


def test_synth_equals_jax_key_by_key():
    for jcfg, tcfg in CONFIGS.values():
        a, b = j_synth(jcfg), tsynth.synth_sam_state_dict(tcfg)
        assert list(a) == list(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_from_flax_loads_the_same_module(nets):
    _, jcfg, tcfg, sd, _, model, _ = nets
    got = tconvert.sam_from_flax(jconvert.convert_sam(sd, depth=jcfg.depth))
    assert set(got) == set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    assert tie.config_from_state_dict(sd) == tcfg


@pytest.mark.parametrize("kind", ["windowed", "global"])
def test_block(nets, kind):
    name, jcfg, tcfg, _, tree, model, (bound, _) = nets
    i = 0 if kind == "windowed" else jcfg.global_attn_indexes[0]
    S = jcfg.img_size // jcfg.patch_size
    x = np.random.default_rng(i).normal(size=(2, S, S, jcfg.embed_dim)).astype(np.float32)
    ws = 0 if kind == "global" else jcfg.window_size
    want = jie.Block(jcfg, ws).apply({"params": tree["image_encoder"][f"block{i}"]}, x)
    got = model.image_encoder.blocks[i](torch.from_numpy(x))
    assert rel(got, want) <= bound
    if kind == "windowed":
        assert (S % jcfg.window_size != 0) == (name == "padded")


@pytest.fixture(scope="module")
def encoded(nets):
    jcfg, tree = nets[1], nets[4]
    x = np.random.default_rng(1).normal(size=(1, jcfg.img_size, jcfg.img_size, 3))
    x = x.astype(np.float32)
    return x, np.asarray(jie.ImageEncoderViT(jcfg).apply({"params": tree["image_encoder"]}, x))


def test_encoder(nets, encoded):
    x, want = encoded
    got = nets[5].image_encoder(torch.from_numpy(x))
    assert got.shape == want.shape
    assert rel(got, want) <= nets[6][0]


@pytest.fixture(scope="module")
def prompts(nets):
    jcfg, tree = nets[1], nets[4]
    r = np.random.default_rng(3)
    pts = (r.random((5, 2, 2)) * jcfg.img_size).astype(np.float32)
    labels = np.tile(np.asarray([[1.0, -1.0]], np.float32), (5, 1))
    labels[2, 0] = 0.0
    S = jcfg.img_size // jcfg.patch_size
    pe = JPromptEncoder(embed_dim=jcfg.out_chans, image_embedding_size=(S, S),
                        input_image_size=(jcfg.img_size, jcfg.img_size))
    sparse, dense = pe.apply({"params": tree["prompt_encoder"]}, pts, labels)
    image_pe = pe.apply({"params": tree["prompt_encoder"]}, method=JPromptEncoder.get_dense_pe)
    return pts, labels, sparse, dense, image_pe


def test_prompt_encoder(nets, prompts):
    pts, labels, sparse, dense, image_pe = prompts
    model, (_, bound) = nets[5], nets[6]
    t_sparse, t_dense = model.prompt_encoder(torch.from_numpy(pts), torch.from_numpy(labels))
    assert rel(t_sparse, sparse) <= bound
    assert np.array_equal(t_dense.numpy(), np.asarray(dense))
    assert rel(model.prompt_encoder.get_dense_pe(), image_pe) <= bound


def test_mask_decoder(nets, prompts):
    _, jcfg, _, _, tree, model, (_, bound) = nets
    _, _, sparse, dense, image_pe = prompts
    S = jcfg.img_size // jcfg.patch_size
    feats = np.random.default_rng(4).normal(size=(1, S, S, jcfg.out_chans)).astype(np.float32)
    masks, iou = JDecoder(transformer_dim=jcfg.out_chans).apply(
        {"params": tree["mask_decoder"]}, feats, image_pe, sparse, dense)
    t_masks, t_iou = model.mask_decoder(*(torch.from_numpy(np.asarray(a)) for a in
                                          (feats, image_pe, sparse, dense)))
    assert t_masks.shape == masks.shape == (5, 4, 4 * S, 4 * S)
    assert rel(t_masks, masks) <= bound
    assert rel(t_iou, iou) <= bound


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_tanh_gelu(nets, encoded, prompts, part):
    """``gelu_approx``, which the bf16 path switches on, against JAX's in
    float32."""
    _, jcfg, tcfg, sd, tree, _, (enc_bound, dec_bound) = nets
    model = build_sam(sd, dataclasses.replace(tcfg, gelu_approx=True), "cpu")
    if part == "encoder":
        x, _ = encoded
        want = jie.ImageEncoderViT(dataclasses.replace(jcfg, gelu_approx=True)).apply(
            {"params": tree["image_encoder"]}, x)
        assert rel(model.image_encoder(torch.from_numpy(x)), want) <= enc_bound
        return
    _, _, sparse, dense, image_pe = prompts
    S = jcfg.img_size // jcfg.patch_size
    feats = np.random.default_rng(4).normal(size=(1, S, S, jcfg.out_chans)).astype(np.float32)
    masks, iou = JDecoder(transformer_dim=jcfg.out_chans, gelu_approx=True).apply(
        {"params": tree["mask_decoder"]}, feats, image_pe, sparse, dense)
    t_masks, t_iou = model.mask_decoder(*(torch.from_numpy(np.asarray(a)) for a in
                                          (feats, image_pe, sparse, dense)))
    assert rel(t_masks, masks) <= dec_bound
    assert rel(t_iou, iou) <= dec_bound


def test_bf16_predictor_tracks_f32():
    """The bf16 predictor (the frontend's) against the float32 one on
    weights at a trained net's scale: features and the decoded logits and
    IoU, relative to the float32 run's largest magnitude."""
    _, tcfg = CONFIGS["padded"]
    sd = tsynth.scale_like_trained(tsynth.synth_sam_state_dict(tcfg))
    p32 = TPredictor(sd, tcfg, device="cpu")
    p16 = TPredictor(sd, tcfg, compute_dtype=torch.bfloat16, device="cpu")
    r = np.random.default_rng(7)
    image = r.integers(0, 255, (72, 90, 3), np.uint8)
    p32.set_image(image)
    p16.set_image(image)
    assert p16._features.dtype == torch.float32
    pts = torch.from_numpy((r.random((6, 2)) * np.asarray([95.0, 76.0])).round().astype(np.float32))
    (m32, i32), (m16, i16) = p32._decode(pts), p16._decode(pts)
    errs = rel(p16._features, p32._features), rel(m16, m32), rel(i16, i32)
    assert max(errs) <= BF16_BOUND, errs


@pytest.fixture(scope="module")
def predictors():
    jcfg, tcfg = CONFIGS["tiny"]
    sd = j_synth(jcfg)
    tree = jax.tree.map(jnp.asarray, jconvert.convert_sam(sd, depth=jcfg.depth))
    return JPredictor(tree, jcfg), TPredictor(sd, tcfg, device="cpu")


def test_set_image_non_square(predictors):
    jp, tp = predictors
    image = np.random.default_rng(5).integers(0, 255, (48, 60, 3), np.uint8)
    jp.set_image(image)
    tp.set_image(image)
    assert tp._input_hw == jp._input_hw == (51, 64)
    assert rel(tp._features, jp._features) <= ENC_BOUND
    # the same array object encodes once; a prepared frame encodes to the
    # same features
    feats = tp._features
    tp.set_image(image)
    assert tp._features is feats
    frame = tp.prepare_frame(image, image.shape[:2])
    tp.set_image(frame)
    assert tp._last_image is frame and torch.equal(tp._features, feats)
    assert tp._input_hw == (51, 64) and tp._orig_hw == (48, 60)


def test_select_round(predictors):
    """select_dispatch + select_finish against the JAX predictor's round
    (out_size = S = 16, s = 4), exactly; no interpolant of the round's
    logits lies within 1e-4 of a threshold, so a flip would show."""
    jp, tp = predictors
    r = np.random.default_rng(6)
    image = r.integers(0, 255, (48, 60, 3), np.uint8)
    jp.set_image(image)
    tp.set_image(image)
    pts = (r.random((9, 2)) * np.asarray([63.0, 50.0])).round().astype(np.float32)
    lowres = tp._decode(torch.from_numpy(pts))[0][:, 1:].double()
    up = torch.nn.functional.interpolate(lowres, scale_factor=4, mode="bilinear")[:, :, :51, :64]
    for t in (-1.0, 0.0, 1.0):
        assert float((up - t).abs().min()) > 1e-4 and float((lowres - t).abs().min()) > 1e-4
    for stab_thr in (0.0, 0.5):
        want = jp.predict_points_select(pts, iou_threshold=0.0, stability_threshold=stab_thr,
                                        nms_enabled=True, box_nms_thresh=0.8,
                                        filter_by_box_size=True, out_size=16)
        handle = tp.select_dispatch(pts, 0.0, stab_thr, out_size=16)
        got = tp.select_finish(handle, nms_enabled=True, box_nms_thresh=0.8,
                               filter_by_box_size=True)
        assert got["keypoints_ids"].size > 0
        for k in ("keypoints_ids", "masks_ids", "boxes", "masks"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["iou_preds"], want["iou_preds"], rtol=DEC_BOUND)
