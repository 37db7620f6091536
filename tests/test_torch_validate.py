"""``nets/validate.py`` of the PyTorch port against the JAX package's
(CPU, float32): the same converted trees (oracle-scaled synthetic weights,
the tiny SAM and the B5 NNET) on the same image, tier 1 on both sides.

Bounds: the image embedding's std within 3.5e-6 relative (the encoder's
bound in ``test_torch_nets_sam.py``); the IoU predictions of the nine grid
prompts within 4.0e-6 of the largest (the decoder's); the mean normal
length within 1e-5 (``test_torch_nets_nnet.py``'s NNET bound).
"""

import jax
import numpy as np
import pytest

from super_primitive_tpu.nets import convert as jconvert
from super_primitive_tpu.nets import validate as jvalidate
from super_primitive_tpu.nets.sam.image_encoder import VIT_TINY_TEST as J_TINY
from super_primitive_tpu_torch.nets import synth, validate

ENC_BOUND, DEC_BOUND, NNET_BOUND = 3.5e-6, 4.0e-6, 1e-5


@pytest.fixture(scope="module")
def image():
    return validate.sample_image((48, 64))


def test_sample_image_equals_jax(image):
    np.testing.assert_array_equal(image, jvalidate._test_image((48, 64)))


def test_validate_sam_matches_jax(image):
    tree = jconvert.convert_sam(synth.scale_like_trained(synth.synth_sam_state_dict(
        J_TINY)), depth=J_TINY.depth)
    want = jvalidate.validate_sam(jax.tree.map(np.asarray, tree), image=image, cfg=J_TINY)
    got = validate.validate_sam(tree, image=image, device="cpu")
    assert got["tier"] == 1 and got["finite"]
    assert abs(got["embed_std"] - want["flax_embed_std"]) <= ENC_BOUND * want["flax_embed_std"]
    iou, jiou = np.asarray(got["iou"]), np.asarray(want["flax_iou"])
    np.testing.assert_allclose(iou, jiou, rtol=0, atol=DEC_BOUND * np.abs(jiou).max())


def test_validate_nnet_matches_jax(image):
    tree = jconvert.convert_nnet(synth.synth_nnet_state_dict())
    want = jvalidate.validate_nnet(jax.tree.map(np.asarray, tree), image=image,
                                   network_dim=(64, 96))
    got = validate.validate_nnet(tree, image=image, network_dim=(64, 96), device="cpu")
    assert got["tier"] == 1 and got["finite"]
    assert abs(got["norm_len_mean"] - want["flax_norm_len_mean"]) <= NNET_BOUND
