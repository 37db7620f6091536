"""BiNI normal integration: the PyTorch port against the JAX package on the
CPU, at 48x64 plane normals with 4 masks, 2 outer iterations and at most
200 CG iterations.

On the CPU the JAX package solves every field with its host ``_pcg``; the
port takes the K2 plain version for fields K2's launch plan holds
(``stencil.cg_holds``) and ``_pcg`` for the others.  Both are the same
per-segment CG, so the log-depths agree to 1e-3 absolute.  The
system pieces (coefficients, edge masks, system, weights) agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.data.synthetic import PlanesSequence
from super_primitive_tpu.integrate import bini as jbini
from super_primitive_tpu_torch.integrate import bini as tbini

H, W = 48, 64
JCFG = jbini.BiniConfig(outer_iters=2, cg_max_iter=200, cg_tol=1e-3)
TCFG = tbini.BiniConfig(outer_iters=2, cg_max_iter=200, cg_tol=1e-3)


@pytest.fixture(scope="module")
def case():
    seq = PlanesSequence(n_frames=1, H=H, W=W)
    normals = seq[0]["normals"]
    K = seq.K
    masks = np.zeros((4, H, W), bool)
    masks[0, 4:20, 6:26] = True           # fits the 32 crop
    masks[1, 28:46, 40:62] = True         # fits, near the border
    masks[2, 2:46, 2:62] = True           # oversized for a 32 crop
    r = np.random.default_rng(0)
    masks[3] = r.uniform(size=(H, W)) > 0.5
    masks[3, :, :30] = False
    return normals, K, masks


def tt(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


class TestSystem:
    def test_pieces_match(self, case):
        normals, K, masks = case
        D_t, cu_t, cv_t = tbini._coefficients(tt(normals), tt(K))
        D_j, cu_j, cv_j = jbini._coefficients(jnp.asarray(normals), jnp.asarray(K))
        for a, b in ((D_t, D_j), (cu_t, cu_j), (cv_t, cv_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
        em_t = tbini._edge_masks(torch.from_numpy(masks))
        em_j = jbini._edge_masks(jnp.asarray(masks))
        for k in em_t:
            assert np.array_equal(em_t[k].numpy(), np.asarray(em_j[k]))
        r = np.random.default_rng(1)
        w_u, w_v = (r.uniform(0.1, 0.9, masks.shape).astype(np.float32) for _ in range(2))
        emf_t = {k: v.float() for k, v in em_t.items()}
        emf_j = {k: v.astype(jnp.float32) for k, v in em_j.items()}
        q_t, b_t, d_t = tbini._system(D_t, cu_t, cv_t, emf_t, tt(w_u), tt(w_v))
        q_j, b_j, d_j = jbini._system(D_j, cu_j, cv_j, emf_j, jnp.asarray(w_u), jnp.asarray(w_v))
        for k in q_t:
            np.testing.assert_allclose(q_t[k].numpy(), np.asarray(q_j[k]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5, rtol=0)
        zt = r.normal(size=masks.shape).astype(np.float32) * 0.1
        wt = tbini._weights_from_residuals(tt(zt), D_t, cu_t, cv_t, emf_t, 2.0)
        wj = jbini._weights_from_residuals(jnp.asarray(zt), D_j, cu_j, cv_j, emf_j, 2.0)
        for a, b in zip(wt, wj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)

    def test_crop_window_coefficients(self, case):
        normals, K, _ = case
        crop = normals[10:42, 20:52]
        D_t, _, _ = tbini._coefficients_window(tt(crop), tt(K), 10.0, 20.0)
        D_j, _, _ = jbini._coefficients_window(jnp.asarray(crop), jnp.asarray(K), 10.0, 20.0)
        np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), atol=1e-5, rtol=0)

    def test_bbox_sizes(self, case):
        _, _, masks = case
        hs_t, ws_t = tbini.segment_bbox_sizes(masks)
        hs_j, ws_j = jbini.segment_bbox_sizes(masks)
        assert np.array_equal(hs_t, hs_j) and np.array_equal(ws_t, ws_j)


class TestIntegrate:
    def test_integrate_normals(self, case):
        normals, K, masks = case
        zt_t = tbini.integrate_normals(tt(normals), torch.from_numpy(masks), tt(K), TCFG)
        zt_j = jbini.integrate_normals(jnp.asarray(normals), jnp.asarray(masks),
                                       jnp.asarray(K), JCFG)
        np.testing.assert_allclose(zt_t.numpy(), np.asarray(zt_j), atol=1e-3, rtol=0)
        assert (zt_t.numpy()[~masks] == 0).all()

    @pytest.mark.parametrize("return_crops", [False, True])
    def test_integrate_normals_cropped(self, case, return_crops):
        normals, K, masks = case
        out_t = tbini.integrate_normals_cropped(
            tt(normals), torch.from_numpy(masks[:2]), tt(K), TCFG, crop=32,
            return_crops=return_crops,
        )
        out_j = jbini.integrate_normals_cropped(
            jnp.asarray(normals), jnp.asarray(masks[:2]), jnp.asarray(K), JCFG,
            crop=32, return_crops=return_crops,
        )
        if return_crops:
            for a, b in zip(out_t[1:], out_j[1:]):
                assert np.array_equal(a.numpy(), np.asarray(b))
            out_t, out_j = out_t[0], out_j[0]
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-3, rtol=0)

    def test_pcg_route_matches(self, case):
        """The K1-per-iteration route (``_pcg``) against the JAX ``_pcg``."""
        normals, K, masks = case
        D, c_u, c_v = tbini._coefficients(tt(normals), tt(K))
        em = {k: v.float() for k, v in tbini._edge_masks(torch.from_numpy(masks)).items()}
        half = torch.full(masks.shape, 0.5)
        q, b, diag = tbini._system(D, c_u, c_v, em, half, half)
        qs = [q[k].expand(masks.shape).contiguous() for k in ("up", "um", "vp", "vm")]
        maskf = torch.from_numpy(masks).float()
        from super_primitive_tpu_torch.ops import stencil

        x_t, it_t = tbini._pcg(lambda x: stencil.bini_apply(x, *qs), b * maskf,
                               torch.zeros_like(maskf), torch.from_numpy(masks), diag, 200, 1e-3)
        jq = [jnp.asarray(a.numpy()) for a in qs]
        from super_primitive_tpu.ops.pallas_stencil import bini_apply_reference

        x_j, it_j = jbini._pcg(lambda x: bini_apply_reference(x, *jq),
                               jnp.asarray((b * maskf).numpy()), jnp.zeros(masks.shape),
                               jnp.asarray(masks), jnp.asarray(diag.numpy()), 200, 1e-3)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=2e-4, rtol=0)
        assert abs(it_t - int(it_j)) <= 2

    def test_plain_flag_is_the_cpu_route(self, case):
        normals, K, masks = case
        cfg = tbini.BiniConfig(outer_iters=1, cg_max_iter=50)
        a = tbini.integrate_normals(tt(normals), torch.from_numpy(masks[:2]), tt(K), cfg)
        b = tbini.integrate_normals(tt(normals), torch.from_numpy(masks[:2]), tt(K), cfg,
                                    plain=True)
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,route", [((2, 12, 16), "bini_cg"), ((2, 1, 3616), "bini_apply")])
def test_routes_on_what_k2_holds(monkeypatch, shape, route):
    """A field K2's plan holds takes K2; a 1x3616 row, which K2 does not
    hold (one CTA's shared memory), takes ``_pcg`` on K1.  Either way the
    result agrees with the JAX package."""
    from super_primitive_tpu_torch.ops import stencil

    N, h, w = shape
    r = np.random.default_rng(2)
    normals = r.normal(size=(h, w, 3)).astype(np.float32)
    normals[..., 2] = -np.abs(normals[..., 2]) - 1.0
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    K = np.array([[1.08 * w, 0, w / 2], [0, 1.08 * w, h / 2], [0, 0, 1]], np.float32)
    masks = r.uniform(size=shape) > 0.3
    called = {"bini_cg": 0, "bini_apply": 0}
    for name in called:
        def spy(*args, _name=name, _fn=getattr(stencil, name)):
            called[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(stencil, name, spy)
    cfg_t = tbini.BiniConfig(outer_iters=2, cg_max_iter=100)
    cfg_j = jbini.BiniConfig(outer_iters=2, cg_max_iter=100)
    zt_t = tbini.integrate_normals(tt(normals), torch.from_numpy(masks), tt(K), cfg_t)
    zt_j = jbini.integrate_normals(jnp.asarray(normals), jnp.asarray(masks), jnp.asarray(K), cfg_j)
    assert stencil.cg_holds(h, w) == (route == "bini_cg")
    assert called[route] > 0 and sum(called.values()) == called[route]
    np.testing.assert_allclose(zt_t.numpy(), np.asarray(zt_j), atol=1e-3, rtol=0)
