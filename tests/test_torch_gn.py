"""The GN/LM path of the PyTorch port against the JAX package (CPU).

Inputs: seeded numpy arrays and the 3-keyframe window of
``tests/test_mapping.py`` (the rendered plane sequence at 48x64 through the
GT-depth grid stub, poses and log-depths perturbed), built in both
packages.  Tolerances, each case's own:

- the sampling gradients: 1e-6 absolute; packed equals unpacked bit for bit
  on valid points;
- ``adjoint`` 1e-6; ``linearize_warp``: against ``torch.func.jacfwd`` of the
  port's ``residual_warp`` (2e-4 absolute + 1e-4 relative, the JAX
  package's own bound for its oracle) and against JAX's (1e-5 of max|J|);
- ``assemble``: factored against direct, H, g_t, D, gl, Bs within 1e-5 of
  their largest magnitude; each against JAX, the gradients g_t and gl within
  5e-5 and the weight-bearing blocks H, D and Bs within 5e-4, the cost within
  relative 1e-5.  The IRLS weight 1/max(|r|, 1e-3) amplifies one-ulp
  differences of the residual on this near-exact window (torch's and XLA's
  float32 ``exp`` already differ by an ulp on some points): JAX against
  itself with the log-depths one ulp up moves Bs by 1.2e-4, D by 5.1e-5
  and H by 1.4e-5 of their largest magnitude;
- ``solve_step`` on the same inputs: 1e-4 of max|step| (a Schur
  complement of an ill-conditioned camera block);
- ``gn_track`` from the same start: pose within 1e-4 in |log|, costs
  within relative 1e-5, and the same iteration count unless the longer
  run's extra iterations move its cost by less than the stop tolerance
  (relative 1e-6) plus twice JAX's final distance from the float64 floor
  (JAX's LM run in float64 to convergence, ``float64_floor``): at the
  converged floor the accept test reads float32 noise (with L2 weights
  JAX rejects 16 steps in a row where the port accepts a one-ulp gain and
  stops; with L1 weights JAX itself stops after 16, 17 or 22 iterations,
  2.7e-6 apart in cost, when the log-depths move one ulp, and ends 2.1e-6
  above the float64 floor, so a longer run may still gain that much:
  ``tests/torch_diagnostics.py gn``); ``gn_track_frame`` over two levels:
  pose within 1e-4, final costs within relative 1e-5;
- ``gn_mapping`` by cost and accuracy: final cost within relative 1e-3 of
  JAX's, pose error to the truth no worse than 1.1x JAX's (LM's damping
  path may part on float32 noise; the trajectories are not compared);
- the scale-gauge pin: the null direction is cost-neutral (relative 2e-4),
  the pinned init solve keeps the mean log-depth within 5e-4 of its start;
- ``run_supp_refinement_gn``: log-depths within 5e-4, costs within 1e-5;
- ``fused_frame_step``: pose within 1e-4 in |log|, affine 1e-6, gating
  within relative 1e-4, the track cost within relative 1e-5, the
  log-depth row within 5e-4;
- ``solve_two_frame_gn``: per-level costs within relative 1e-3; the pose
  within 1e-3 (rotation |log| and translation direction) up to the scale
  gauge: two-frame SfM leaves depth and translation scale free, and LM
  drifts along that cost-neutral direction on float32 noise, so the
  translation's log-scale must equal the mean log-depth shift (1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from float64_reference import jax_in_float64
from test_odometry import PlaneSequence

from super_primitive_tpu import keyframe as jkf
from super_primitive_tpu.cost import photometric as jph
from super_primitive_tpu.frontend.stub import GridSegmentFrontend as JGrid
from super_primitive_tpu.image import pyramid as jpyr
from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu.odometry import mapper as jmap
from super_primitive_tpu.odometry import window as jwin
from super_primitive_tpu.odometry.fused_step import fused_frame_step as j_fused
from super_primitive_tpu.ops import sampling as jsam
from super_primitive_tpu.solve import gauss_newton as jgn
from super_primitive_tpu.solve import gn_mapping as jgm
from super_primitive_tpu.solve import two_frame as jtf
from super_primitive_tpu_torch import keyframe as tkf
from super_primitive_tpu_torch.cost import photometric as tph
from super_primitive_tpu_torch.frontend.stub import GridSegmentFrontend as TGrid
from super_primitive_tpu_torch.image import pyramid as tpyr
from super_primitive_tpu_torch.odometry import mapper as tmap
from super_primitive_tpu_torch.odometry import window as twin
from super_primitive_tpu_torch.odometry.fused_step import fused_frame_step as t_fused
from super_primitive_tpu_torch.ops import sampling as tsam
from super_primitive_tpu_torch.solve import gauss_newton as tgn
from super_primitive_tpu_torch.solve import gn_mapping as tgm
from super_primitive_tpu_torch.solve import two_frame as ttf

GEO = (48, 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: beside the other test workers, torch's thread
    pool spends more time waiting on its own threads than computing, so
    this module runs on one (restored after it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def npy(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def pose_err(A, B):
    return float(np.linalg.norm(np.asarray(jse3.log(J(np.linalg.inv(npy(A)) @ npy(B))))))


def close_to_max(got, want, rel, name=""):
    got, want = npy(got), npy(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6),
                               err_msg=name)


# ----------------------------------------------------------------- sampling

@pytest.fixture(scope="module")
def sample_inputs():
    r = np.random.default_rng(0)
    img = r.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    coords = r.uniform(-1.1, 1.1, (3, 400, 2)).astype(np.float32)
    return img, coords


class TestSamplingGrad:
    def test_sample_grad(self, sample_inputs):
        img, coords = sample_inputs
        st, dt, vt = tsam.bilinear_sample_grad(T(img), T(coords))
        sj, dj, vj = jsam.bilinear_sample_grad(J(img), J(coords))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6, rtol=0)

    def test_cell_index_and_taps(self, sample_inputs):
        img, coords = sample_inputs
        it, wxt, wyt, vt = tsam.bilinear_cell_index(T(coords), (24, 32))
        ij, wxj, wyj, vj = jsam.bilinear_cell_index(J(coords), (24, 32))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(wxt.numpy(), np.asarray(wxj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(wyt.numpy(), np.asarray(wyj), atol=1e-6, rtol=0)
        assert int(it.min()) >= 0 and int(it.max()) < 24 * 32  # clamped in bounds
        pool = tsam.pack_bilinear_taps(T(img)).reshape(24 * 32, 12)
        st, dt = tsam.bilinear_grad_from_taps(pool[it], wxt, wyt, (24, 32))
        sj, dj = jsam.bilinear_grad_from_taps(
            jnp.take(jsam.pack_bilinear_taps(J(img)).reshape(24 * 32, 12), ij, axis=0),
            wxj, wyj, (24, 32))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6, rtol=0)

    def test_packed_equals_unpacked_on_valid_points(self, sample_inputs):
        img, coords = sample_inputs
        packed = tsam.pack_bilinear_taps(T(img))
        s_p, d_p, v_p = tsam.bilinear_sample_grad_packed(packed, T(coords))
        s_u, d_u, v_u = tsam.bilinear_sample_grad(T(img), T(coords))
        v = v_u.numpy()
        assert v.sum() > 500 and (~v).sum() > 50
        np.testing.assert_array_equal(v_p.numpy(), v)
        np.testing.assert_array_equal(s_p.numpy()[v], s_u.numpy()[v])
        np.testing.assert_array_equal(d_p.numpy()[v], d_u.numpy()[v])
        s_j, d_j, _ = jsam.bilinear_sample_grad_packed(jsam.pack_bilinear_taps(J(img)), J(coords))
        np.testing.assert_allclose(s_p.numpy()[v], np.asarray(s_j)[v], atol=1e-6, rtol=0)
        np.testing.assert_allclose(d_p.numpy()[v], np.asarray(d_j)[v], atol=1e-6, rtol=0)
        # a stack of packed images samples each at its own coords
        s_b, _ = tsam.bilinear_sample_packed(torch.stack([packed, 2 * packed]), T(coords[:2]))
        np.testing.assert_array_equal(s_b[1].numpy()[v[1]], 2 * s_p[1].numpy()[v[1]])


# ------------------------------------------------------------ warp Jacobian

def warp_inputs(P=257, H=24, W=32, img_hw=None, seed=3):
    r = np.random.default_rng(seed)
    K = np.asarray([[1.1 * W, 0, W / 2], [0, 1.1 * W, H / 2], [0, 0, 1.0]], np.float32)
    X = np.stack([r.uniform(-0.4, 0.4, P), r.uniform(-0.3, 0.3, P),
                  r.uniform(0.5, 2.0, P)], -1).astype(np.float32)
    X[0, 2] = 1e-8  # the projection guard
    src_px = r.uniform(0, 1, (P, 3)).astype(np.float32)
    vstat = r.uniform(size=P) > 0.1
    rel = np.asarray(jse3.exp(J(0.05 * r.normal(size=6))))
    img = r.uniform(0, 1, (img_hw or (H, W)) + (3,)).astype(np.float32)
    return K, X, src_px, vstat, rel, img


class TestWarp:
    def test_adjoint(self):
        Tm = np.asarray(jse3.exp(J([0.3, -0.2, 0.1, 0.5, -0.4, 0.2])))
        np.testing.assert_allclose(tgm.adjoint(T(Tm)).numpy(), np.asarray(jgm.adjoint(J(Tm))),
                                   atol=1e-6, rtol=0)

    @pytest.mark.parametrize("use_affine", [False, True])
    def test_linearize_warp(self, use_affine):
        K, X, src_px, vstat, rel, img = warp_inputs()
        aff_s, aff_t = np.float32([0.05, -0.02]), np.float32([-0.03, 0.04])
        args_t = (T(X), T(src_px), torch.from_numpy(vstat), T(rel), T(K), T(img), (24, 32),
                  T(aff_s), T(aff_t), use_affine)
        r0, valid, Jt = tgm.linearize_warp(*args_t)
        r_ref, _ = tgm.residual_warp(*args_t, torch.zeros(11))
        J_ref = torch.func.jacfwd(lambda loc: tgm.residual_warp(*args_t, loc)[0])(torch.zeros(11))
        np.testing.assert_allclose(r0.numpy(), r_ref.numpy(), atol=1e-6)
        np.testing.assert_allclose(Jt.numpy(), J_ref.numpy(), atol=2e-4, rtol=1e-4)
        rj, vj, Jj = jgm.linearize_warp(J(X), J(src_px), jnp.asarray(vstat), J(rel), J(K),
                                        J(img), (24, 32), J(aff_s), J(aff_t), use_affine)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
        close_to_max(r0, rj, 1e-5)
        close_to_max(Jt, Jj, 1e-5)

    def test_pooled_taps_at_coarse_image_dims(self):
        """Taps gathered from an image smaller than the geometry grid (a
        coarse level) give the direct sampling's residual and Jacobian."""
        K, X, src_px, vstat, rel, img = warp_inputs(img_hw=(6, 8), seed=5)
        a0 = torch.zeros(2)
        args = (T(X), T(src_px), torch.from_numpy(vstat), T(rel), T(K))
        r_ref, v_ref, J_ref = tgm.linearize_warp(*args, T(img), (24, 32), a0, a0, False)
        p = T(X) @ T(rel)[:3, :3].T + T(rel)[:3, 3]
        coords = tph.normalized_image_coords(
            torch.stack([p[:, 0] * K[0, 0] / p[:, 2] + K[0, 2],
                         p[:, 1] * K[1, 1] / p[:, 2] + K[1, 2]], -1), (24, 32))
        idx, wx, wy, okb = tsam.bilinear_cell_index(coords, (6, 8))
        pool = tsam.pack_bilinear_taps(T(img)).reshape(48, 12)
        r0, valid, Jp = tgm.linearize_warp(*args, None, (24, 32), a0, a0, False,
                                           taps=(pool[idx], wx, wy, okb), taps_hw=(6, 8))
        assert torch.isfinite(r0).all() and torch.isfinite(Jp).all()
        np.testing.assert_array_equal(valid.numpy(), v_ref.numpy())
        np.testing.assert_allclose(r0.numpy(), r_ref.numpy(), atol=1e-6)
        np.testing.assert_allclose(Jp.numpy(), J_ref.numpy(), atol=1e-5)


# ------------------------------------------------------------------ window

def make_window():
    """The window of tests/test_mapping.py in both packages: 3 keyframes
    (frames 0, 3, 6) with one supporting frame each (the next frame, at its
    true pose); all but the first keyframe's pose and log-depths perturbed."""
    ds = PlaneSequence(n_frames=9, H=48, W=64)
    fe_j, fe_t = JGrid(rows=3, cols=4), TGrid(rows=3, cols=4)
    r = np.random.default_rng(0)
    jw = jwin.empty_window(3, 2, GEO, 3, 16, 4096)
    tw = twin.empty_window(3, 2, GEO, 3, 16, 4096, device="cpu")
    gt_poses = []
    for slot, fid in enumerate((0, 3, 6)):
        frame = ds[fid]
        fe_j.observe(frame)
        fe_t.observe(frame)
        kf = fe_j.process_to_kf(frame["image"], frame["intrinsics"])
        n = kf["regions"].shape[0]
        kp_base = kf["logdepth_perseg"][np.arange(n), kf["keypoints_rc"][:, 0],
                                        kf["keypoints_rc"][:, 1]]
        pose = np.asarray(frame["T"], np.float32)
        gt_poses.append(pose)
        kp_ld = kp_base.copy()
        if slot > 0:
            pose = np.asarray(jse3.retract(J(pose), J(0.01 * r.normal(size=6))))
            kp_ld = kp_base + r.normal(0, 0.02, n).astype(np.float32)
        jb = jkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"], capacity=4096)
        jw = jwin.set_keyframe_slot(
            jw, slot, kf["image"], kf["K"], pose, kp_ld, np.zeros(2, np.float32),
            np.asarray(jb.uv), np.asarray(jb.seg_id), np.asarray(jb.base_logdepth),
            np.asarray(jb.valid), int(jb.num_valid), kp_base)
        tb = tkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"], capacity=4096,
                                 device="cpu")
        twin.set_keyframe_slot(tw, slot, kf["image"], kf["K"], pose, kp_ld,
                               np.zeros(2, np.float32), tb, kp_base)
        supp = ds[fid + 1]
        supp_img = np.asarray(supp["image"], np.float32) / 255.0
        jw = jwin.set_supporting_slot(jw, slot, 0, supp_img, supp["T"], np.zeros(2, np.float32))
        twin.set_supporting_slot(tw, slot, 0, T(supp_img), supp["T"], np.zeros(2, np.float32))
    return jw, tw, gt_poses, ds


@pytest.fixture(scope="module")
def window_setup():
    return make_window()


def window_args(jw, num_kfs=3, mode="map", opt_supporting=False, affine=False):
    supp_valid = np.asarray(jw.supp_valid)
    slots = jmap.build_slots(num_kfs, jw.capacity, supp_valid, mode)
    masks = jmap.build_masks(num_kfs, jw.capacity, supp_valid, mode, jw.capacity,
                             opt_supporting, affine)
    return slots, masks


def par_mask_of(masks):
    return np.concatenate([np.repeat(masks.xi_mask, 6), np.repeat(masks.affine_mask, 2)])


def assemble_both(jw, tw, slots, masks, use_affine, factored=True):
    pm = par_mask_of(masks)
    ti = jnp.asarray(slots.trg_index)
    want = jgm.assemble(jw, ti, jnp.asarray(slots.trg_valid), jnp.asarray(slots.src_valid),
                        jw.image_pool()[ti], jw.source_samples(GEO), jnp.asarray(pm), GEO,
                        use_affine, jw.pose_pool(), jw.kp_logdepth, jw.affine_pool(),
                        factored=factored)
    got = tgm.assemble(tw, slots.trg_index, slots.trg_valid, slots.src_valid, T(pm), GEO,
                       use_affine, tw.pose_pool(), tw.kp_logdepth, tw.affine_pool(),
                       factored=factored)
    return got, want


NAMES = ("H", "g_t", "D", "gl", "Bs")
JAX_TOL = {"H": 5e-4, "g_t": 5e-5, "D": 5e-4, "gl": 5e-5, "Bs": 5e-4}


class TestAssemble:
    @pytest.mark.parametrize("use_affine", [False, True])
    def test_factored_direct_and_jax(self, window_setup, use_affine):
        jw, tw, _, _ = window_setup
        slots, masks = window_args(jw, opt_supporting=use_affine, affine=use_affine)
        got_f, want = assemble_both(jw, tw, slots, masks, use_affine, factored=True)
        got_d = tgm.assemble(tw, slots.trg_index, slots.trg_valid, slots.src_valid,
                             T(par_mask_of(masks)), GEO, use_affine, tw.pose_pool(),
                             tw.kp_logdepth, tw.affine_pool(), factored=False)
        for k, name in enumerate(NAMES):
            close_to_max(got_f[k], got_d[k], 1e-5, "factored vs direct " + name)
            close_to_max(got_f[k], want[k], JAX_TOL[name], "port vs JAX " + name)
        for got in (got_f, got_d):
            np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-5)
        assert float(np.abs(npy(want[4])).max()) > 0 and float(want[5]) > 0

    def test_cmap(self, window_setup):
        jw, _, _, _ = window_setup
        slots, _ = window_args(jw)
        np.testing.assert_array_equal(tgm.build_cmap(slots.trg_index, 9),
                                      np.asarray(jgm.build_cmap(jnp.asarray(slots.trg_index), 9)))
        np.testing.assert_array_equal(tgm.col16(1, 4, 9), np.asarray(jgm.col16(1, 4, 9)))

    def test_solve_step_same_inputs(self, window_setup):
        jw, _, _, _ = window_setup
        slots, masks = window_args(jw)
        pm = par_mask_of(masks)
        ti = jnp.asarray(slots.trg_index)
        lin = jgm.assemble(jw, ti, jnp.asarray(slots.trg_valid), jnp.asarray(slots.src_valid),
                           jw.image_pool()[ti], jw.source_samples(GEO), jnp.asarray(pm), GEO,
                           False, jw.pose_pool(), jw.kp_logdepth, jw.affine_pool())
        ld_w = np.asarray(masks.ld_mask)[:, None] * np.asarray(jw.kf_valid)[:, None] * np.ones(
            (1, 16), np.float32)
        cmap = jgm.build_cmap(ti, 9)
        dt_j, dl_j = jgm.solve_step(*lin[:5], jnp.float32(1e-3), J(ld_w), J(pm), cmap)
        dt_t, dl_t = tgm.solve_step(*(T(np.asarray(x)) for x in lin[:5]), torch.tensor(1e-3),
                                    T(ld_w), T(pm), torch.from_numpy(np.asarray(cmap)))
        close_to_max(dt_t, dt_j, 1e-4, "d_theta")
        close_to_max(dl_t, dl_j, 1e-4, "d_l")
        assert float(np.abs(np.asarray(dt_j)).max()) > 0


# ------------------------------------------------------------------ solvers

def float64_floor(jb, kf_image, trg, K, kp_logdepth, kp_base, R0, use_affine, robust):
    """The cost JAX's ``gn_track`` converges to in float64 (stop tolerance
    1e-12) from R0: the floor the float32 runs approach."""
    def final_cost(jb, kf_image, trg, K, kp_logdepth, kp_base, R0):
        src = jph.precompute_source(kf_image, jb, GEO)
        res = jgn.gn_track(jb, src, trg, K, kp_logdepth, kp_base, R0, jnp.zeros(2), jnp.zeros(2),
                           GEO, max_iters=200, use_affine=use_affine, robust=robust, tol=1e-12)
        return float(res.final_cost)
    return jax_in_float64(final_cost)(jb, kf_image, J(trg), K, kp_logdepth, kp_base, J(R0))


class TestGNTrack:
    @pytest.mark.parametrize("robust,use_affine", [("l1", False), ("l1", True),
                                                   ("huber", False), ("none", False)])
    def test_matches_jax(self, window_setup, robust, use_affine):
        jw, tw, gt, ds = window_setup
        # keyframe 0 against frame 2 from a perturbed start
        T_init = np.asarray(jse3.retract(J(ds.poses[2]), J([0.01, -0.015, 0.01, -0.02, 0.03,
                                                             0.02])))
        R0 = (np.linalg.inv(T_init) @ gt[0]).astype(np.float32)
        trg = np.asarray(ds[2]["image"], np.float32) / 255.0
        if use_affine:
            trg = np.clip(trg * 0.8 + 0.1, 0, 1).astype(np.float32)
        jb, tb = jw.bundle_at(0), tw.bundle_at(0)
        src_j = jph.precompute_source(jw.images[0], jb, GEO)
        src_t = tph.precompute_source(tw.images[0], tb, GEO)
        def run_j(n):
            return jgn.gn_track(jb, src_j, J(trg), jw.K[0], jw.kp_logdepth[0], jw.kp_base[0],
                                J(R0), jnp.zeros(2), jnp.zeros(2), GEO, max_iters=n,
                                use_affine=use_affine, robust=robust)

        def run_t(n):
            return tgn.gn_track(tb, src_t, T(trg), tw.K[0], tw.kp_logdepth[0], tw.kp_base[0],
                                T(R0), torch.zeros(2), torch.zeros(2), GEO, max_iters=n,
                                use_affine=use_affine, robust=robust)

        rj, rt = run_j(25), run_t(25)
        n_j, n_t = int(rj.num_iters), rt.num_iters
        if n_t != n_j:  # only at the floor: the longer run's extra steps gain < tol
            longer, n = (run_j, n_j) if n_j > n_t else (run_t, n_t)
            c_short = float(longer(min(n_j, n_t)).final_cost)
            c_long = float(longer(n).final_cost)
            # ... or what JAX's own stop left above the float64 floor
            floor = float64_floor(jb, jw.images[0], trg, jw.K[0], jw.kp_logdepth[0],
                                  jw.kp_base[0], R0, use_affine, robust)
            slack = 2 * abs(float(rj.final_cost) - floor) + 1e-6 * c_long
            assert abs(c_short - c_long) < slack, (n_t, n_j, c_short, c_long, floor)
        assert pose_err(rt.R, rj.R) < 1e-4
        np.testing.assert_allclose(rt.affine.numpy(), np.asarray(rj.affine), atol=1e-5)
        np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-5)
        assert float(rt.final_cost) < float(rt.initial_cost)

    def test_track_frame_levels(self, window_setup):
        jw, tw, gt, ds = window_setup
        T_init = np.asarray(jse3.retract(J(ds.poses[2]), J([0.01, 0, 0, 0.02, 0, 0])))
        trg = np.asarray(ds[2]["image"], np.float32) / 255.0
        jb, tb = jw.bundle_at(0), tw.bundle_at(0)
        Tj, aj, ij = jgn.gn_track_frame(
            jb, jpyr.image_pyramid(jw.images[0], 0, 2), jpyr.image_pyramid(J(trg), 0, 2),
            jw.K[0], jw.kp_logdepth[0], jw.kp_base[0], jw.poses[0], J(T_init), jnp.zeros(2),
            jnp.zeros(2), GEO, levels=[0, 1], max_iters=15)
        Tt, at, it = tgn.gn_track_frame(
            tb, tpyr.image_pyramid(tw.images[0], 0, 2), tpyr.image_pyramid(T(trg), 0, 2),
            tw.K[0], tw.kp_logdepth[0], tw.kp_base[0], tw.poses[0], T(T_init), torch.zeros(2),
            torch.zeros(2), GEO, levels=[0, 1], max_iters=15)
        for a, b in zip(it, ij):
            np.testing.assert_allclose(float(a.final_cost), float(b.final_cost), rtol=1e-5)
        assert pose_err(Tt, Tj) < 1e-4
        assert pose_err(Tt, ds.poses[2]) < 0.5 * pose_err(T_init, ds.poses[2])


def map_both(jw, tw, slots, masks, **kw):
    want = jgm.gn_mapping(jw, *(jnp.asarray(x) for x in (*slots, *masks)), GEO, **kw)
    got = tgm.gn_mapping(tw, *slots, *masks, GEO, **kw)
    return got, want


class TestGNMapping:
    @pytest.mark.parametrize("point_stride", [1, 2])
    def test_cost_and_accuracy(self, window_setup, point_stride):
        jw, tw, gt, _ = window_setup
        slots, masks = window_args(jw)
        got, want = map_both(jw, tw, slots, masks, max_iters=25, point_stride=point_stride)
        np.testing.assert_allclose(float(got.initial_cost), float(want.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-3)
        assert float(got.final_cost) < 0.7 * float(got.initial_cost)
        for i in (1, 2):
            e_t, e_j = pose_err(got.poses[i], gt[i]), pose_err(want.poses[i], gt[i])
            assert e_t <= 1.1 * e_j, (i, e_t, e_j)
            assert e_t < pose_err(tw.poses[i], gt[i])
        np.testing.assert_allclose(got.poses[0].numpy(), tw.poses[0].numpy(), atol=1e-6)

    def test_factored_and_direct_converge_alike(self, window_setup):
        jw, tw, gt, _ = window_setup
        slots, masks = window_args(jw)
        res_f = tgm.gn_mapping(tw, *slots, *masks, GEO, max_iters=15, factored=True)
        res_d = tgm.gn_mapping(tw, *slots, *masks, GEO, max_iters=15, factored=False)
        np.testing.assert_allclose(float(res_f.final_cost), float(res_d.final_cost), rtol=1e-3)

    def test_affine_and_drag(self, window_setup):
        """Affines free and supporting poses dragged with their keyframe."""
        jw, tw, gt, _ = window_setup
        slots, masks = window_args(jw, opt_supporting=False, affine=True)
        got, want = map_both(jw, tw, slots, masks, max_iters=10, use_affine=True,
                             drag_supporting=True)
        np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-3)
        for i in (1, 2):
            assert pose_err(got.poses[i], gt[i]) <= 1.1 * pose_err(want.poses[i], gt[i])
        # a dragged supporting pose takes its keyframe's steps
        for i in (1, 2):
            moved_kf = np.linalg.inv(tw.poses[i].numpy()) @ got.poses[i].numpy()
            moved_supp = np.linalg.inv(tw.supp_poses[i, 0].numpy()) @ got.poses[3 + 2 * i].numpy()
            assert pose_err(moved_kf, np.eye(4)) > 1e-3
            np.testing.assert_allclose(moved_supp, moved_kf, atol=1e-5)


class TestScaleGaugePin:
    @staticmethod
    def rebased(tw):
        """The port window with every pose left-multiplied by T0^-1 (the
        first keyframe at the identity; the cost sees relative poses only)."""
        T0_inv = torch.linalg.inv(tw.poses[0])
        return twin.WindowBuffers(**{**tw.__dict__, "poses": T0_inv @ tw.poses,
                                     "supp_poses": T0_inv @ tw.supp_poses})

    def test_null_direction_is_cost_neutral(self, window_setup):
        _, tw, _, _ = window_setup
        slots, masks = window_args(window_setup[0])
        pm = T(par_mask_of(masks))
        c = 0.1
        scaled = twin.WindowBuffers(**{**tw.__dict__})
        scaled.kp_logdepth = tw.kp_logdepth + c
        scaled.poses = tw.poses.clone()
        scaled.poses[:, :3, 3] *= np.exp(c)
        scaled.supp_poses = tw.supp_poses.clone()
        scaled.supp_poses[:, :, :3, 3] *= np.exp(c)
        costs = [float(tgm.assemble(b, slots.trg_index, slots.trg_valid, slots.src_valid, pm,
                                    GEO, False, b.pose_pool(), b.kp_logdepth,
                                    b.affine_pool())[5]) for b in (tw, scaled)]
        np.testing.assert_allclose(costs[1], costs[0], rtol=2e-4)

    def test_pinned_init_solve(self, window_setup):
        jw, tw, _, _ = window_setup
        tw = self.rebased(tw)
        supp_valid = np.zeros((3, 2), bool)
        slots = tmap.build_slots(2, 3, supp_valid, "map")
        masks = tmap.build_masks(2, 3, supp_valid, "map", 3, False, False)
        res_u = tgm.gn_mapping(tw, *slots, *masks, GEO, max_iters=20)
        res_p = tgm.gn_mapping(tw, *slots, *masks, GEO, max_iters=20, pin_scale_gauge=True)
        assert float(res_p.final_cost) < float(res_p.initial_cost)
        assert float(res_p.final_cost) <= float(res_u.final_cost) * 1.05 + 1e-8
        ld0 = tw.kp_logdepth[:2, :12].numpy()
        assert abs(float(np.mean(res_p.kp_logdepth[:2, :12].numpy() - ld0))) < 5e-4
        np.testing.assert_allclose(res_p.poses[0].numpy(), tw.poses[0].numpy(), atol=1e-6)


class TestSuppAndFused:
    def test_supp_refinement_gn(self, window_setup):
        jw, tw, _, _ = window_setup
        slots, _ = window_args(jw, mode="supp")
        ld_j, costs_j = jmap.run_supp_refinement_gn(
            jw, jnp.asarray(2), jnp.asarray(slots.trg_index[2]),
            jnp.asarray(slots.trg_valid[2]), False, GEO)
        ld_t, costs_t, iters = tmap.run_supp_refinement_gn(
            tw, 2, slots.trg_index[2], slots.trg_valid[2], False, GEO)
        assert 1 <= iters <= 6
        assert float(costs_t[1]) < float(costs_t[0])
        np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=5e-4, rtol=0)
        np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j), atol=1e-5, rtol=0)

    @pytest.mark.parametrize("with_prev", [False, True])
    def test_fused_frame_step(self, window_setup, with_prev):
        jw, tw, _, ds = window_setup
        tw = twin.WindowBuffers(**{k: (v.clone() if torch.is_tensor(v) else v.copy())
                                   for k, v in tw.__dict__.items()})
        i, fid = 2, 8
        trg = np.asarray(ds[fid]["image"], np.float32) / 255.0
        T_init = np.asarray(jse3.retract(J(ds.poses[fid]), J([0.005, 0, 0, 0.01, 0, 0])))
        prev_img = np.asarray(ds[7]["image"], np.float32) / 255.0
        prev_pose = np.asarray(ds.poses[7], np.float32)
        supp_valid = np.asarray(jw.supp_valid).copy()
        supp_valid[i] = [True, with_prev]
        slots = jmap.build_slots(3, 3, supp_valid, "supp")
        _, packed_j, ld_j = j_fused(
            jw, jnp.asarray(i), J(trg), J(T_init), jnp.zeros(2), J(prev_img), J(prev_pose),
            jnp.zeros(2), jnp.asarray(with_prev), jnp.asarray(slots.trg_index[i]),
            jnp.asarray(slots.trg_valid[i]), GEO, (1,), 0, 2, max_iters=15)
        res = t_fused(
            tw, i, T(trg), T(T_init), torch.zeros(2), T(prev_img) if with_prev else None,
            T(prev_pose) if with_prev else None, torch.zeros(2) if with_prev else None,
            slots.trg_index[i], slots.trg_valid[i], GEO, [1], 0, 2, max_iters=15)
        pj = np.asarray(packed_j)
        pt = res.packed
        assert pt.shape == (22,) and np.isfinite(pt).all()
        assert pose_err(pt[:16].reshape(4, 4), pj[:16].reshape(4, 4)) < 1e-4
        np.testing.assert_allclose(pt[16:18], pj[16:18], atol=1e-6)
        np.testing.assert_allclose(pt[18:21], pj[18:21], rtol=1e-4)
        np.testing.assert_allclose(pt[21], pj[21], rtol=1e-5)
        np.testing.assert_allclose(res.kp_logdepth.numpy(), np.asarray(ld_j), atol=5e-4)
        np.testing.assert_array_equal(tw.supp_valid[i].numpy(), [True, with_prev])
        assert torch.equal(tw.kp_logdepth[i], res.kp_logdepth)
        assert res.supp_iters >= 1 and len(res.track_iters) == 1


# ----------------------------------------------------------------- two-frame

def test_solve_two_frame_gn():
    seq = PlaneSequence(n_frames=4, H=48, W=64)
    src, trg = seq[0], seq[3]
    stub = JGrid(rows=3, cols=4)
    stub.observe(src)
    kf = stub.process_to_kf(src["image"], src["intrinsics"])
    supp_img = np.asarray(trg["image"], np.float32) / 255.0
    kp = 2.0 * kf["keypoints_rc"] / (np.asarray(kf["regions"].shape[1:]) - 1) - 1.0
    T_rel = (np.linalg.inv(trg["T"]) @ src["T"]).astype(np.float32)
    T_init = (T_rel @ np.asarray(jse3.exp(J(np.full(6, 0.01))))).astype(np.float32)
    ld0 = np.log(np.random.default_rng(43).uniform(1.5, 2.5, len(kp))).astype(np.float32)

    jgeo = jkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"])
    jbun = jkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"])
    mk_j = lambda im, g=None: jkf.KeyFrame(image=J(im), K=J(kf["K"]), K_img=J(kf["K"]), geo=g)  # noqa: E731
    Pj, ld_j, Lj = jtf.solve_two_frame_gn(
        jkf.keyframe_pyramid(mk_j(kf["image"], jgeo), 0, 2, bundle=jbun),
        [jkf.keyframe_pyramid(mk_j(supp_img), 0, 2)], J(T_init)[None], J(ld0), max_iters=10)

    tgeo = tkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"], device="cpu")
    tbun = tkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"], device="cpu")
    mk_t = lambda im, g=None: tkf.KeyFrame(image=T(im), K=T(kf["K"]), K_img=T(kf["K"]), geo=g)  # noqa: E731
    Pt, ld_t, Lt = ttf.solve_two_frame_gn(
        tkf.keyframe_pyramid(mk_t(kf["image"], tgeo), 0, 2, bundle=tbun),
        [tkf.keyframe_pyramid(mk_t(supp_img), 0, 2)], T(T_init)[None], T(ld0), max_iters=10)
    np.testing.assert_allclose(np.asarray(Lt), np.asarray(Lj), rtol=1e-3)
    Pt, Pj = Pt[0].numpy(), np.asarray(Pj[0])
    Pt, Pj = Pt.astype(np.float64), Pj.astype(np.float64)
    cos_r = (np.trace(Pt[:3, :3].T @ Pj[:3, :3]) - 1.0) / 2.0
    assert np.arccos(np.clip(cos_r, -1.0, 1.0)) < 1e-3
    t_t, t_j = Pt[:3, 3], Pj[:3, 3]
    cos_t = np.dot(t_t, t_j) / (np.linalg.norm(t_t) * np.linalg.norm(t_j))
    assert np.arccos(np.clip(cos_t, -1.0, 1.0)) < 1e-3
    gauge = np.log(np.linalg.norm(t_t) / np.linalg.norm(t_j))
    assert abs(gauge - float(np.mean(ld_t.numpy() - np.asarray(ld_j)))) < 1e-3
    assert pose_err(Pt, T_rel) < 0.7 * pose_err(T_init, T_rel)
    assert ld_t.shape == (len(kp),) and len(Lt) == 2
