"""The BiNI stencil kernels' plain versions (K1 ``bini_apply``, K2
``bini_cg``) against the JAX package, and the wrappers' dispatch.

On the CPU the wrappers take the plain versions; the CUDA kernels
themselves are held against the plain versions in the ``cuda``-marked test
below (it skips without a card) and in ``chip_smoke.py``.

Tolerances: K1 relative 1e-5 (same float32 math, sums in another order);
K2 2e-4 absolute on the solution (CG iterates amplify rounding
differences, as in tests/test_bini_kernel_cg.py).  On the card K2 is held
to 1e-4 x max|x| with a residual within 1.5x of the plain one, and to the
plain version's iteration counts wherever the two solutions are equal.

K2's launch plan (``cg_plan``) and the predicate BiNI routes on
(``cg_holds``) are pure functions of the field's shape and are tested here
on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.integrate import bini as jbini
from super_primitive_tpu.ops import pallas_stencil as jst
from super_primitive_tpu_torch.integrate import bini as tbini
from super_primitive_tpu_torch.ops import stencil as tst

DIRS = ("up", "um", "vp", "vm")


def make_fields(seed=0, N=3, H=16, W=24):
    """BiNI-shaped inputs from the JAX package's _system: q, b, diag,
    masks and a random masked p, as numpy arrays."""
    r = np.random.default_rng(seed)
    K = jnp.asarray([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1.0]])
    normals = r.normal(size=(H, W, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    masks = r.uniform(size=(N, H, W)) > 0.4
    D, c_u, c_v = jbini._coefficients(jnp.asarray(normals), K)
    em = {k: v.astype(jnp.float32) for k, v in jbini._edge_masks(jnp.asarray(masks)).items()}
    w_u = jnp.asarray(r.uniform(0.2, 0.8, (N, H, W)).astype(np.float32))
    w_v = jnp.asarray(r.uniform(0.2, 0.8, (N, H, W)).astype(np.float32))
    q, b, diag = jbini._system(D, c_u, c_v, em, w_u, w_v)
    q = [np.asarray(jnp.broadcast_to(q[k], masks.shape)) for k in DIRS]
    p = r.normal(size=(N, H, W)).astype(np.float32) * masks
    b = np.asarray(jnp.broadcast_to(b, masks.shape)) * masks
    diag = np.asarray(jnp.broadcast_to(diag, masks.shape))
    return q, p, masks, b.astype(np.float32), diag


def t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


class TestApplyPlain:
    @pytest.mark.parametrize("seed,N,H,W", [(0, 3, 16, 24), (1, 2, 33, 17)])
    def test_matches_jax_reference_and_interpret(self, seed, N, H, W):
        q, p, *_ = make_fields(seed, N, H, W)
        ap_t, dot_t = tst.bini_apply_reference(*t(p, *q))
        jargs = [jnp.asarray(a) for a in (p, *q)]
        for ap_j, dot_j in (jst.bini_apply_reference(*jargs),
                            jst.bini_apply_pallas(*jargs, interpret=True)):
            scale = float(np.abs(np.asarray(ap_j)).max())
            np.testing.assert_allclose(ap_t.numpy(), np.asarray(ap_j), atol=1e-5 * scale, rtol=0)
            np.testing.assert_allclose(dot_t.numpy(), np.asarray(dot_j), rtol=1e-5)

    def test_wraps_for_any_q(self):
        """The shifts wrap around, so the plain version equals the roll form
        for q with non-zero borders too."""
        r = np.random.default_rng(3)
        p, *q = (r.normal(size=(2, 8, 9)).astype(np.float32) for _ in range(5))
        ap_t, _ = tst.bini_apply_reference(*t(p, *q))
        ap_j, _ = jst.bini_apply_reference(*(jnp.asarray(a) for a in (p, *q)))
        np.testing.assert_allclose(ap_t.numpy(), np.asarray(ap_j), atol=1e-5, rtol=0)


class TestCGPlain:
    @pytest.mark.parametrize("tol", [1e-3, 1e-7])
    def test_matches_interpret_kernel_and_pcg(self, tol):
        q, _, masks, b, diag = make_fields(seed=3, N=3, H=16, W=24)
        maskf = masks.astype(np.float32)
        x0 = np.zeros_like(b)
        x_t, it_t = tst.bini_cg_reference(*t(b, x0, maskf, diag, *q), 200, tol)
        jargs = [jnp.asarray(a) for a in (b, x0, maskf, diag, *q)]
        x_k = np.asarray(jst.bini_cg_pallas(*jargs, max_iter=200, tol=tol, interpret=True))
        apply_A = lambda x: jst.bini_apply_reference(x, *jargs[4:])  # noqa: E731
        x_p, _ = jbini._pcg(apply_A, jargs[0], jargs[1], jnp.asarray(masks),
                            jargs[3], 200, tol)
        m = masks
        np.testing.assert_allclose(x_t.numpy()[m], x_k[m], atol=2e-4, rtol=0)
        np.testing.assert_allclose(x_t.numpy()[m], np.asarray(x_p)[m], atol=2e-4, rtol=0)
        assert (x_t.numpy()[~m] == 0).all()
        assert it_t.dtype == torch.int32 and (it_t > 0).all() and (it_t <= 200).all()

    def test_iteration_cap_and_empty_segment(self):
        q, _, masks, b, diag = make_fields(seed=4, N=2, H=12, W=12)
        masks[1] = False  # an empty segment converges at once
        maskf = masks.astype(np.float32)
        b = b * masks
        _, it = tst.bini_cg_reference(*t(b, np.zeros_like(b), maskf, diag, *q), 5, 1e-9)
        assert it.tolist() == [5, 0]


class TestDispatch:
    def test_cpu_takes_plain_version_without_counting(self):
        q, p, masks, b, diag = make_fields()
        tst.reset_launch_counts()
        ap, dots = tst.bini_apply(*t(p, *q))
        ap_r, dots_r = tst.bini_apply_reference(*t(p, *q))
        assert torch.equal(ap, ap_r) and torch.equal(dots, dots_r)
        x, it = tst.bini_cg(*t(b, np.zeros_like(b), masks, diag, *q), 50, 1e-3)
        x_r, it_r = tst.bini_cg_reference(*t(b, np.zeros_like(b), masks, diag, *q), 50, 1e-3)
        assert torch.equal(x, x_r) and torch.equal(it, it_r)
        assert tst.launch_counts == {"bini_apply": 0, "bini_cg": 0}

    def test_other_devices_raise(self):
        p = torch.zeros((1, 4, 4), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tst.bini_apply(p, p, p, p, p)
        with pytest.raises(ValueError, match="no kernel"):
            tst.bini_cg(p, p, p, p, p, p, p, p, 10, 1e-3)

    @pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "rank"])
    def test_field_checks(self, bad):
        f = torch.zeros((2, 4, 6))
        g = {
            "dtype": f.double(),
            "shape": torch.zeros((2, 4, 5)),
            "layout": torch.zeros((2, 6, 4)).transpose(1, 2),
            "rank": torch.zeros((4, 6)),
        }[bad]
        fields = (g, f) if bad == "rank" else (f, g)
        with pytest.raises(ValueError):
            tst._check_fields("k", fields)


# The plans PERF.md names for the VO path's crop buckets and the full
# 240x320 field: (cluster, threads, shared bytes)
NAMED_PLANS = {
    (32, 32): (1, 512, 34_880),
    (64, 64): (8, 256, 19_520),
    (128, 128): (8, 512, 70_720),
    (240, 320): (16, 608, 164_928),
}


def bands(H, C):
    """Rows of each CTA's band: CTA k holds rows k*H//C to (k+1)*H//C."""
    return [(k + 1) * H // C - k * H // C for k in range(C)]


# The JAX package gives K2 every field whose ten f32 fields stay under the
# TPU's 8 MiB (its bini.py:258-260)
JAX_K2_FIELD_BYTES = 8 * 2**20


class TestCgPlan:
    @pytest.mark.parametrize("H", [1, 2, 3, 15, 16, 17, 31, 64, 100, 128, 191, 240, 333, 600])
    def test_every_shape_under_the_limit_has_a_plan_or_raises(self, H):
        """Every (H, W) the JAX package gives its K2 gets a plan that fits
        one CTA's shared memory and 16 CTAs, or raises exactly where no
        cluster of min(16, H) CTAs cuts it into bands one CTA holds;
        ``cg_holds`` tells the two apart."""
        w_max = -(-JAX_K2_FIELD_BYTES // (40 * H)) - 1
        assert H * w_max * 40 < JAX_K2_FIELD_BYTES
        rows = -(-H // min(16, H))
        w_cap = tst.K2_BAND_PIXELS_MAX // rows  # no plan holds a wider field
        widths = [*range(1, min(w_cap + 2, w_max) + 1), *range(w_cap + 2, w_max + 1, 97), w_max]
        for W in widths:
            holds = (rows * W <= tst.K2_BAND_PIXELS_MAX
                     and tst.cg_smem_bytes(rows, W) <= 232_448)
            assert tst.cg_holds(H, W) == holds
            if not holds:
                with pytest.raises(ValueError, match="no plan holds"):
                    tst.cg_plan(H, W)
                continue
            C, T, smem = tst.cg_plan(H, W)
            assert 1 <= C <= min(16, H) and smem <= 232_448
            assert T % 32 == 0 and 32 <= T <= 1024
            assert tst.cg_pixels_per_thread(H, W, C, T) in (2, 4, 8)

    @pytest.mark.parametrize("shape", sorted(NAMED_PLANS))
    def test_path_shapes_get_the_named_plans(self, shape):
        assert tuple(tst.cg_plan(*shape)) == NAMED_PLANS[shape]

    @pytest.mark.parametrize("shape", sorted(NAMED_PLANS) + [(1, 3000), (5, 7), (17, 33), (250, 320)])
    def test_threads_cover_every_band(self, shape):
        H, W = shape
        C, T, smem = tst.cg_plan(H, W)
        ppt = tst.cg_pixels_per_thread(H, W, C, T)
        assert all(rows >= 1 and rows * W <= T * ppt for rows in bands(H, C))
        assert max(bands(H, C)) == -(-H // C)
        # p, q_up, q_um, 1/diag, mask, best x, q_vp, q_vm a pixel; q_vp's,
        # q_vm's and p's halo rows and the four-row mailbox a column
        assert smem == 8 * 136 + 4 * (8 * max(bands(H, C)) * W + 8 * W)

    def test_plans_the_kernel_would_refuse(self):
        C, T, _ = tst.cg_plan(64, 64)
        for bad in [(C, T + 1), (C, 32), (17, T), (0, T), (C, 2048), (65, T)]:
            assert tst.cg_pixels_per_thread(64, 64, *bad) == 0

    @pytest.mark.parametrize("shape,holds", [
        ((32, 32), True), ((128, 128), True), ((240, 320), True), ((1, 3615), True),
        ((1, 3616), False), ((100, 800), False), ((340, 600), False), ((480, 640), False),
    ])
    def test_routing_follows_the_plan(self, shape, holds):
        """BiNI gives K2 the fields it holds: the crop buckets and 240x320
        do, a 1x3616 row overflows one CTA's shared memory, and 100x800,
        340x600 and 480x640 overflow 16 CTAs of 5120 pixels."""
        assert tst.cg_holds(*shape) == holds
        if not holds:
            with pytest.raises(ValueError, match="no plan holds"):
                tst.cg_plan(*shape)


def ring_fields(seed, N, H, W):
    """Positive q everywhere, borders included, so the stencil's
    wrap-around terms count: row 0's upper neighbour is row H-1."""
    r = np.random.default_rng(seed)
    q = [r.uniform(0.1, 1.1, (N, H, W)).astype(np.float32) for _ in range(4)]
    roll = lambda x, a, b: np.roll(x, (a, b), axis=(-2, -1))  # noqa: E731
    diag = (q[0] + roll(q[0], 0, 1) + q[1] + roll(q[1], 0, -1)
            + q[2] + roll(q[2], 1, 0) + q[3] + roll(q[3], -1, 0))
    masks = r.uniform(size=(N, H, W)) > 0.2
    b = r.normal(size=(N, H, W)).astype(np.float32) * masks
    p = r.normal(size=(N, H, W)).astype(np.float32) * masks
    return q, p, masks, b, diag


@pytest.mark.cuda
class TestKernelsOnCard:
    """Run with ``python -m pytest tests/test_torch_stencil.py -m cuda`` on a
    machine with a card; skips elsewhere."""

    def test_kernels_match_plain_versions(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        q, p, masks, b, diag = make_fields(seed=5, N=4, H=40, W=56)
        dev = [a.cuda() for a in t(p, *q)]
        ap_k, dot_k = tst.bini_apply(*dev)
        ap_r, dot_r = tst.bini_apply_reference(*dev)
        torch.testing.assert_close(ap_k, ap_r, atol=1e-5 * float(ap_r.abs().max()), rtol=0)
        torch.testing.assert_close(dot_k, dot_r, rtol=1e-5, atol=0)
        args = [a.cuda() for a in t(b, 0.01 * p, masks, diag, *q)]  # warm start
        x_k, it_k = tst.bini_cg(*args, 300, 1e-3)
        x_r, it_r = tst.bini_cg_reference(*args, 300, 1e-3)
        torch.testing.assert_close(x_k, x_r, atol=1e-4 * float(x_r.abs().max()), rtol=0)

    @pytest.mark.parametrize("kind,N,H,W", [
        ("bini", 2, 32, 32), ("bini", 34, 64, 64), ("bini", 14, 128, 128),
        ("bini", 2, 240, 320), ("ring", 2, 32, 32), ("ring", 3, 128, 128),
        ("ring", 2, 240, 320),
    ])
    def test_k2_matches_plain_version(self, kind, N, H, W):
        """K2 on its cluster plan at the VO path's bucket shapes, the full
        field, and a q with non-zero borders (the ring halo) on one CTA, 8
        CTAs and 16 CTAs a segment."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        fields = make_fields if kind == "bini" else ring_fields
        q, p, masks, b, diag = fields(7, N, H, W)
        args = [a.cuda() for a in t(b, 0.01 * p, masks, diag, *q)]
        x_k, it_k = tst.bini_cg(*args, 1000, 1e-3)
        x_r, it_r = tst.bini_cg_reference(*args, 1000, 1e-3)
        torch.testing.assert_close(x_k, x_r, atol=1e-4 * float(x_r.abs().max()), rtol=0)
        res = [torch.linalg.vector_norm(
            ((args[0] - tst.bini_apply_reference(x, *args[4:])[0] * args[2]) * args[2]).flatten(1),
            dim=1) for x in (x_k, x_r)]
        assert float((res[0] / res[1].clamp(min=1e-30)).max()) <= 1.5
        same = [bool(torch.equal(a, c)) for a, c in zip(x_k, x_r)]
        assert all(int(i) == int(j) for i, j, s_ in zip(it_k, it_r, same) if s_)
        assert tst.launch_counts["bini_cg"] >= 1
