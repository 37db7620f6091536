"""The residual channel modes (``cost/normal_modes.py`` and
``photometric_cost(mode=)``) of the PyTorch port against the JAX package,
on ``tests/test_normal_modes.py``'s cases (CPU, float32).

Bounds: the channel splits are slices, equal exactly; the rotated normals
within 1e-6; the cost in every mode within 1e-6 of JAX's, with the normal
channels never entering it (two images that differ only there give the
same cost) and ``norm_kappa`` a zero cost; ``mode="colour"`` equal to the
call without ``mode``, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.cost import normal_modes as jnm
from super_primitive_tpu.cost import photometric as jph
from super_primitive_tpu.keyframe import build_bundle_np as j_bundle
from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu_torch.cost import normal_modes as tnm
from super_primitive_tpu_torch.cost import photometric as tph
from super_primitive_tpu_torch.keyframe import build_bundle_np as t_bundle
from super_primitive_tpu_torch.lie import se3 as tse3
from super_primitive_tpu_torch.ops.sampling import pack_bilinear_taps

CHANNELS = {"colour": 3, "colour_norm": 6, "colour_norm_kappa": 7, "norm_kappa": 4}


@pytest.mark.parametrize("mode", tnm.MODES)
def test_split_by_mode(mode):
    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    x = x[:, :CHANNELS[mode]] if mode == "norm_kappa" else x
    got = tnm.split_by_mode(torch.from_numpy(x), mode)
    want = jnm.split_by_mode(jnp.asarray(x), mode)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="unknown mode"):
        tnm.split_by_mode(torch.from_numpy(x), "normals")


@pytest.mark.parametrize("mode", tnm.MODES)
def test_transform_normals(mode):
    r = np.random.default_rng(1)
    xi = np.asarray([0.3, -0.2, 0.4, 1.0, 0.0, 0.0], np.float32)
    pix = r.normal(size=(10, CHANNELS[mode])).astype(np.float32)
    t_pix = torch.from_numpy(pix)
    got = tnm.transform_normals(t_pix, tse3.exp(torch.from_numpy(xi)), mode)
    want = jnm.transform_normals(jnp.asarray(pix), jse3.exp(jnp.asarray(xi)), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if mode == "colour":
        assert got is t_pix
    else:  # the colour (and kappa) channels pass through unchanged
        keep = slice(3, 4) if mode == "norm_kappa" else slice(0, 3)
        np.testing.assert_array_equal(got[:, keep].numpy(), pix[:, keep])


def _scene():
    r = np.random.default_rng(0)
    H, W = 24, 32
    K = np.asarray([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1.0]], np.float32)
    regions = np.zeros((2, H, W), bool)
    regions[0, 4:12, 4:16] = True
    regions[1, 12:20, 16:28] = True
    logdepth = np.full((2, H, W), 0.5, np.float32) * regions
    kp = np.asarray([[8, 10], [16, 22]], np.int64)
    kp_base = logdepth[np.arange(2), kp[:, 0], kp[:, 1]]
    rgb = r.uniform(0, 1, (H, W, 3)).astype(np.float32)
    # the channels after the colour ones (norm_kappa: the whole image)
    extra = {m: [r.normal(size=(H, W, CHANNELS[m] - (m != "norm_kappa") * 3))
                 .astype(np.float32) for _ in range(2)]
             for m in CHANNELS if m != "colour"}
    return H, W, K, regions, logdepth, kp_base, rgb, extra


@pytest.mark.parametrize("mode", tnm.MODES)
@pytest.mark.parametrize("moved", [False, True])
def test_cost_by_mode_matches_jax(mode, moved):
    """The cost of the source image against targets whose normal (and
    kappa) channels differ from the source's: at the identity and at a
    moved pose."""
    H, W, K, regions, logdepth, kp_base, rgb, extra = _scene()
    xi = np.asarray([0.01, -0.02, 0.015, 0.02, -0.01, 0.005] if moved else [0.0] * 6, np.float32)
    if mode == "colour":
        src_img = trg_img = rgb
    elif mode == "norm_kappa":
        src_img, trg_img = extra[mode]
    else:
        src_img = np.concatenate([rgb, extra[mode][0]], -1)
        trg_img = np.concatenate([rgb, extra[mode][1]], -1)

    jb = j_bundle(regions, logdepth, capacity=1024)
    j_src = jph.precompute_source(jnp.asarray(src_img), jb, (H, W))
    want = float(jph.photometric_cost(
        jb, j_src, jnp.asarray(trg_img), jnp.asarray(K), (H, W), jnp.asarray(kp_base),
        jnp.asarray(kp_base), jse3.exp(jnp.asarray(xi)), mode=mode))

    tb = t_bundle(regions, logdepth, capacity=1024, device="cpu")
    t_src = tph.precompute_source(torch.from_numpy(src_img), tb, (H, W))
    args = (tb, t_src, pack_bilinear_taps(torch.from_numpy(trg_img)), torch.from_numpy(K),
            (H, W), torch.from_numpy(kp_base), torch.from_numpy(kp_base),
            tse3.exp(torch.from_numpy(xi)))
    got = tph.photometric_cost(*args, mode=mode)
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want)), (float(got), want)
    if mode == "norm_kappa":
        assert float(got) == 0.0
    if mode == "colour":
        assert torch.equal(got, tph.photometric_cost(*args))
    if mode in ("colour_norm", "colour_norm_kappa"):
        # the normal channels never enter the residual
        same = np.concatenate([rgb, extra[mode][0]], -1)
        args_same = args[:2] + (pack_bilinear_taps(torch.from_numpy(same)),) + args[3:]
        assert abs(float(tph.photometric_cost(*args_same, mode=mode)) - float(got)) <= 1e-7
        if not moved:
            assert float(got) < 1e-6
