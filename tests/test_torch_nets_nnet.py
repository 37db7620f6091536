"""The port's EfficientNet-B5 and NNET against the JAX package's, on the CPU
in float32, with the same synthetic scannet weights (``nets/synth.py``)
carried across by the converters.

Bounds, relative to the reference's largest magnitude: 2e-5 for the B5
stage taps and the head (the JAX package's bound against transformers'
TF-faithful EfficientNet, README.md "Offline torch oracles"); 1e-5 for
the NNET's unit normals and kappa (absolute: they are O(1)).  The odd
input (63x95) makes TensorFlow's SAME padding asymmetric at every stride-2
layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.nets import convert as jconvert
from super_primitive_tpu.nets import efficientnet as jeff
from super_primitive_tpu.nets import nnet as jnnet
from super_primitive_tpu.nets.synth import synth_nnet_state_dict as j_synth
from super_primitive_tpu_torch import convert as tconvert
from super_primitive_tpu_torch.nets import efficientnet as teff
from super_primitive_tpu_torch.nets import nnet as tnnet
from super_primitive_tpu_torch.nets import synth as tsynth

TAP_BOUND, OUT_BOUND = 2e-5, 1e-5
SIZES = [(64, 96), (63, 95)]


def rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


@pytest.fixture(scope="module")
def weights():
    sd = j_synth()
    tree = jconvert.convert_nnet(sd)
    model = tnnet.NNET().eval().requires_grad_(False)
    model.load_state_dict(tconvert.nnet_state_dict(sd))
    return sd, tree, jax.tree.map(jnp.asarray, tree), model


def test_synth_equals_jax_key_by_key():
    a, b = j_synth(), tsynth.synth_nnet_state_dict()
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_from_flax_loads_the_same_module(weights):
    sd, tree, _, model = weights
    got = tconvert.nnet_from_flax(tree)
    want = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the published layout: "module." prefixes, the unused bn2, batch counters
    published = {f"module.{k}": v for k, v in sd.items()}
    published["module.decoder.up1._net.1.num_batches_tracked"] = np.zeros((), np.int64)
    assert set(tconvert.nnet_state_dict(published)) == set(want)


def test_b5_channel_plan():
    assert [teff.round_channels(c, 1.6) for c in (16, 24, 40, 80, 112, 192, 320)] == \
        [24, 40, 64, 128, 176, 304, 512]
    assert [teff.round_repeats(r, 2.2) for r in (1, 2, 2, 3, 3, 4, 1)] == [3, 5, 5, 7, 7, 9, 3]


@pytest.mark.parametrize("hw", [(7, 9), (8, 8)])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (5, 2), (5, 1), (3, 1)])
def test_tf_same_pad(hw, kernel, stride):
    x = np.random.default_rng(0).normal(size=(1, *hw, 2)).astype(np.float32)
    want = jeff.tf_same_pad(jnp.asarray(x), kernel, stride)
    got = teff.tf_same_pad(nchw(x), kernel, stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def outputs(request, weights):
    """The JAX package's stage taps, head and NNET output on one input."""
    _, _, jt, _ = weights
    H, W = request.param
    x = np.random.default_rng(H).normal(size=(1, H, W, 3)).astype(np.float32)
    enc = {"params": jt["params"]["encoder"], "batch_stats": jt["batch_stats"]["encoder"]}
    stages, head = jax.jit(jeff.EfficientNetFeatures().apply)(enc, x)
    out = jax.jit(jnnet.NNET().apply)(jt, x)
    return x, stages, head, out


def test_stage_taps_and_head(weights, outputs):
    model = weights[3]
    x, stages, head, _ = outputs
    t_stages, t_head = model.encoder(nchw(x))
    assert len(t_stages) == len(stages) == 7
    for i, (a, b) in enumerate(zip(t_stages + [t_head], list(stages) + [head])):
        a = a.permute(0, 2, 3, 1).numpy()
        assert a.shape == np.asarray(b).shape, i
        assert rel(a, b) <= TAP_BOUND, i


def test_nnet_output(weights, outputs):
    model = weights[3]
    x, _, _, out = outputs
    got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == np.asarray(out).shape
    np.testing.assert_allclose(got, np.asarray(out), atol=OUT_BOUND, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[..., :3], axis=-1), 1.0, atol=1e-5)
    assert (got[..., 3] > 1.0).all()


def test_resize_bilinear_ac():
    """Against JAX within 5e-6 (the two linspaces round their sample points
    differently) and against torch's align_corners=True interpolate."""
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 3)).astype(np.float32)
    for hw in [(10, 14), (9, 13), (3, 4)]:
        want = jnnet.resize_bilinear_ac(jnp.asarray(x), hw)
        got = tnnet.resize_bilinear_ac(nchw(x), hw).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-6, rtol=0)
        ref = torch.nn.functional.interpolate(nchw(x), hw, mode="bilinear", align_corners=True)
        np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,coarse", [("uint8", (30, 40)), ("float", None)],
                         ids=["uint8-coarse", "float-full"])
def test_predict_normals(weights, dtype, coarse):
    _, _, jt, model = weights
    img = np.random.default_rng(3).integers(0, 255, (60, 80, 3), np.uint8)
    if dtype == "float":
        img = img.astype(np.float32) / 255.0
    jn, jk = jnnet.predict_normals(jt, jnp.asarray(img), (64, 96), coarse_hw=coarse)
    tn, tk = tnnet.predict_normals(model, img, (64, 96), coarse_hw=coarse)
    assert tn.shape == jn.shape and tk.shape == jk.shape
    assert tn.shape[:2] == (coarse or (60, 80))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=OUT_BOUND, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=OUT_BOUND, rtol=0)
