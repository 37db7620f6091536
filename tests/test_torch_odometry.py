"""The odometry loop of the PyTorch port against the JAX package (CPU).

Inputs: the rendered plane sequence of ``tests/test_odometry.py`` (48x64,
analytic GT depth) through the GT-depth grid stub frontend.

- ``render_depth``: identical validity, depths within 1e-6;
- ``photometric_cost_batch`` (with and without the affine term): relative
  1e-5 (same float32 math, different summation order);
- the window operations (slot set, supporting slots, roll, clear): equal;
- ``track_level`` (60 Adam steps), one ``run_mapping`` call (30 steps) and
  one supp refinement (10 steps): poses within 1e-4 in |log|, log-depths
  within 5e-4, tracking losses within 5e-5 (Adam in float32 from the same
  start, rounding apart in the last bits; the L1 cost's near-constant
  gradients let a few segments' log-depths drift furthest);
- ``ate_rmse``: equal;
- the whole loop over 8 frames (window 3, Adam, GT init): the same keyframe
  timestamps as JAX's; the tracked poses against JAX's loop with its
  tracking, mapping and supp refinement in float64, within 3e-2 in |log|
  at the largest and 2e-2 at the median (``float64_reference``: JAX's own
  float32 loop reads up to 2.09e-2 and 1.20e-2 from it, because Adam's
  fixed step never settles; the old bounds, 1e-2 and 5e-3 from JAX's
  float32 loop, sat inside that noise).  The loop's solvers are held to
  JAX one call at a time by the tests above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from float64_reference import jax_float64_solvers, near_jax_float64
from test_odometry import PlaneSequence

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.cost import photometric as jph
from super_primitive_tpu.eval.trajectory import ate_rmse as j_ate
from super_primitive_tpu.frontend.stub import GridSegmentFrontend as JGrid
from super_primitive_tpu.keyframe import build_bundle_np as j_bundle
from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu.odometry import mapper as jmap
from super_primitive_tpu.odometry import tracker as jtrack
from super_primitive_tpu.odometry import window as jwin
from super_primitive_tpu.odometry.odometry import Odometry as JOdometry
from super_primitive_tpu.ops.scatter import render_depth as j_render
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.cost import photometric as tph
from super_primitive_tpu_torch.eval.trajectory import ate_rmse as t_ate
from super_primitive_tpu_torch.frontend.stub import GridSegmentFrontend as TGrid
from super_primitive_tpu_torch.keyframe import build_bundle_np as t_bundle
from super_primitive_tpu_torch.odometry import mapper as tmap
from super_primitive_tpu_torch.odometry import tracker as ttrack
from super_primitive_tpu_torch.odometry import window as twin
from super_primitive_tpu_torch.odometry.odometry import Odometry as TOdometry
from super_primitive_tpu_torch.ops.sampling import pack_bilinear_taps
from super_primitive_tpu_torch.ops.scatter import render_depth as t_render

GEO = (48, 64)
LOOP_FRAMES = 8  # the second keyframe comes at frame 6


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def pose_err(A, B):
    return float(np.linalg.norm(np.asarray(jse3.log(J(np.linalg.inv(A) @ B)))))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops (as in ``test_torch_gn.py``): beside the other
    test workers, a thread pool waits more than it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return PlaneSequence(n_frames=12)


def stub_kf(seq, i):
    fe = TGrid(rows=4, cols=5)
    fe.observe(seq[i])
    return fe.process_to_kf(seq[i]["image"], seq[i]["intrinsics"])


def images(seq, i):
    return stub_kf(seq, i)["image"]


def test_render_depth():
    r = np.random.default_rng(0)
    pts = np.stack([r.uniform(-1, 1, 500), r.uniform(-1, 1, 500), r.uniform(0.5, 3, 500)], 1)
    pts[::17, 2] = -1.0
    valid = r.uniform(size=500) > 0.1
    K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    dt, ot = t_render(T(pts), T(K), GEO, valid=torch.from_numpy(valid))
    dj, oj = j_render(J(pts), J(K), GEO, valid=jnp.asarray(valid))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6, rtol=0)
    assert (dt > 0).sum() > 100


@pytest.mark.parametrize("use_affine", [False, True])
def test_photometric_cost_batch(seq, use_affine):
    kf = stub_kf(seq, 0)
    regions, ld = kf["regions"], kf["logdepth_perseg"]
    jb, tb = j_bundle(regions, ld), t_bundle(regions, ld, device="cpu")
    kp = kf["keypoints_rc"]
    kp_base = ld[np.arange(len(kp)), kp[:, 0], kp[:, 1]]
    kp_ld = kp_base + np.random.default_rng(1).normal(0, 0.05, len(kp)).astype(np.float32)
    trg = np.stack([images(seq, i) for i in (1, 2, 3)])
    rel = np.stack([np.linalg.inv(seq.poses[i]) @ seq.poses[0] for i in (1, 2, 3)])
    aff = np.float32([[0.0, 0.0], [0.05, -0.02], [-0.03, 0.01]])
    src_t = tph.precompute_source(T(kf["image"]), tb, GEO)
    src_j = jph.precompute_source(J(kf["image"]), jb, GEO)
    got = tph.photometric_cost_batch(
        tb, src_t, torch.stack([pack_bilinear_taps(T(x)) for x in trg]), T(kf["K"]), GEO,
        T(kp_ld), T(kp_base), T(rel), affine=(T(aff[0]), T(aff)) if use_affine else None)
    want = jph.photometric_cost_batch(
        jb, src_j, J(trg), J(kf["K"]), GEO, J(kp_ld), J(kp_base), J(rel),
        affine=(J(aff[0]), J(aff)) if use_affine else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def fill_windows(seq):
    """The same two keyframes (frames 0 and 4) and supporting frames in a
    JAX and a port window (W=3, S=2)."""
    jw = jwin.empty_window(3, 2, (48, 64), 3, 64, 4096)
    tw = twin.empty_window(3, 2, (48, 64), 3, 64, 4096, device="cpu")
    for slot, i in enumerate((0, 4)):
        kf = stub_kf(seq, i)
        regions, ld, kp = kf["regions"], kf["logdepth_perseg"], kf["keypoints_rc"]
        kp_base = ld[np.arange(len(kp)), kp[:, 0], kp[:, 1]]
        kp_ld = np.log(seq[i]["depth"][kp[:, 0], kp[:, 1]]).astype(np.float32)
        pose = np.asarray(seq.poses[i], np.float32)
        if slot:  # a perturbed second pose for the mapper to fix
            pose = pose @ np.asarray(jse3.exp(J([0.004, -0.003, 0.002, 0.01, -0.01, 0.005])))
        jb = j_bundle(regions, ld, capacity=4096)
        jw = jwin.set_keyframe_slot(
            jw, slot, kf["image"], kf["K"], pose, kp_ld, np.zeros(2), np.asarray(jb.uv),
            np.asarray(jb.seg_id), np.asarray(jb.base_logdepth), np.asarray(jb.valid),
            int(jb.num_valid), kp_base)
        twin.set_keyframe_slot(tw, slot, kf["image"], kf["K"], pose, kp_ld, np.zeros(2),
                               t_bundle(regions, ld, capacity=4096, device="cpu"), kp_base)
    for j, i in enumerate((5, 6)):
        jw = jwin.set_supporting_slot(jw, 1, j, images(seq, i), seq.poses[i], np.zeros(2))
        twin.set_supporting_slot(tw, 1, j, T(images(seq, i)), seq.poses[i], np.zeros(2))
    return jw, tw


def test_window_operations(seq):
    jw, tw = fill_windows(seq)
    for name in ("image_pool", "pose_pool", "affine_pool"):
        np.testing.assert_array_equal(getattr(tw, name)().numpy(), np.asarray(getattr(jw, name)()))
    for i in (0, 1):
        tb, jb = tw.bundle_at(i), jw.bundle_at(i)
        n = int(jb.num_valid)
        assert tb.num_valid == n and tb.capacity == n
        np.testing.assert_array_equal(tb.uv.numpy(), np.asarray(jb.uv)[:n])
        np.testing.assert_array_equal(tb.seg_id.numpy(), np.asarray(jb.seg_id)[:n])
    twin.roll_window(tw)
    jw = jwin.roll_window(jw)
    twin.clear_supporting(tw, 1)
    jw = jwin.clear_supporting(jw, 1)
    for name in ("images", "poses", "kp_logdepth", "kp_base", "supp_valid", "supp_poses",
                 "kf_valid", "uv"):
        np.testing.assert_array_equal(getattr(tw, name).numpy(), np.asarray(getattr(jw, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tw.num_valid, np.asarray(jw.num_valid))


def test_track_level(seq):
    jw, tw = fill_windows(seq)
    T_kf, T_init = seq.poses[0], seq.poses[2] @ np.asarray(jse3.exp(J([0.01, 0, 0, 0.02, 0, 0])))
    R0 = np.linalg.inv(T_init) @ T_kf
    trg = images(seq, 2)
    tb, jb = tw.bundle_at(0), jw.bundle_at(0)
    src_t = tph.precompute_source(tw.images[0], tb, GEO)
    src_j = jph.precompute_source(jw.images[0], jb, GEO)
    opt = ttrack.make_track_optimizer(torch.zeros(2))
    Rt, _, lt = ttrack.track_level(tb, src_t, T(trg), tw.K[0], tw.kp_logdepth[0], tw.kp_base[0],
                                   T(R0), torch.zeros(2), torch.zeros(2), opt, 5e-3, 5e-3, GEO,
                                   60, False)
    Rj, _, _, lj = jtrack.track_level(jb, src_j, J(trg), jw.K[0], jw.kp_logdepth[0],
                                      jw.kp_base[0], J(R0), jnp.zeros(2), jnp.zeros(2), None,
                                      jnp.float32(5e-3), jnp.float32(5e-3), GEO, 60, False)
    assert float(lt[-1]) < 0.5 * float(lt[0])
    assert pose_err(Rt.numpy(), np.asarray(Rj)) < 1e-4
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=5e-5, rtol=0)


@pytest.mark.parametrize("mode", ["init", "supp"])
def test_run_mapping(seq, mode):
    jw, tw = fill_windows(seq)
    supp_valid = np.zeros((3, 2), bool)
    supp_valid[1] = True
    slots = tmap.build_slots(2, 3, supp_valid, mode)
    js = jmap.build_slots(2, 3, supp_valid, mode)
    for a, b in zip(slots, js):
        np.testing.assert_array_equal(a, b)
    if mode == "supp":
        ld_t = tmap.run_supp_refinement(tw, 1, slots.trg_index[1], slots.trg_valid[1],
                                        1e-2, 10, False, GEO)
        ld_j, _ = jmap.run_supp_refinement(jw, jnp.asarray(1), jnp.asarray(js.trg_index[1]),
                                           jnp.asarray(js.trg_valid[1]), jnp.asarray(1e-2),
                                           jnp.asarray(10), False, GEO)
        np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=5e-4, rtol=0)
        return
    masks = tmap.build_masks(2, 3, supp_valid, mode, 3, True, False)
    res_t = tmap.run_mapping(tw, slots, masks, 1e-2, 1e-2, 1e-5, 30, True, False, GEO)
    res_j = jmap.run_mapping(jw, *(jnp.asarray(x) for x in (*js, *masks)),
                             jnp.asarray(1e-2), jnp.asarray(1e-2), jnp.asarray(1e-5),
                             jnp.asarray(30), jnp.asarray(True), False, GEO,
                             drag_supporting=jnp.asarray(0.0))
    assert res_t.num_iters == int(res_j.num_iters) == 30
    assert res_t.losses[-1] < res_t.losses[0]
    for k in range(9):
        assert pose_err(res_t.poses[k].numpy(), np.asarray(res_j.params.poses[k])) < 1e-4, k
    np.testing.assert_allclose(res_t.kp_logdepth.numpy(), np.asarray(res_j.params.kp_logdepth),
                               atol=5e-4, rtol=0)
    twin_poses = tw.poses.clone()
    tmap.write_back(tw, res_t)
    assert not torch.equal(tw.poses, twin_poses)


def test_ate_rmse(seq):
    r = np.random.default_rng(3)
    gt = {str(k): seq.poses[k] for k in range(12)}
    est = {k: v @ np.asarray(jse3.exp(J(r.normal(0, 0.01, 6)))) for k, v in gt.items()}
    a, b = t_ate(gt, est), j_ate(gt, est)
    assert a == b


def odom_cfg(load_config, save_path):
    return load_config({
        "save_path": str(save_path),
        "window_size": 3,
        "aligment": {
            "mono_init": False, "affine_compensation": False, "opt_supporting": True,
            "init_frames": 3,
            "mapping": {"supp_every_n": 3, "init_steps": 60, "steps": 40, "continual_steps": 5},
            "track": {"lr": 5e-3, "pyramid_min": 0, "pyramid_max": 2, "steps": [0, 250]},
        },
        "kf": {"depth_validity_ratio": 0.60, "translation_thresh": 0.10},
    })


def test_whole_loop(seq, tmp_path):
    jo = JOdometry(odom_cfg(jload_config, tmp_path / "jax"), JGrid(rows=4, cols=5), seq)
    jo.run(max_frames=LOOP_FRAMES)
    to = TOdometry(odom_cfg(tload_config, tmp_path / "torch"), TGrid(rows=4, cols=5), seq,
                   device="cpu")
    to.run(max_frames=LOOP_FRAMES)
    assert sorted(to.global_kf_trajectory) == sorted(jo.global_kf_trajectory)
    assert len(to.global_kf_trajectory) >= 2 and to.num_kfs <= 3
    assert sorted(to.global_track_trajectory) == sorted(jo.global_track_trajectory)
    with jax_float64_solvers():
        ro = JOdometry(odom_cfg(jload_config, tmp_path / "float64"), JGrid(rows=4, cols=5), seq)
        ro.run(max_frames=LOOP_FRAMES)
    assert sorted(ro.global_kf_trajectory) == sorted(jo.global_kf_trajectory)
    near_jax_float64(to.global_track_trajectory, jo.global_track_trajectory,
                     ro.global_track_trajectory)
    gt_errs = [pose_err(T, seq.poses[int(k)]) for k, T in to.global_track_trajectory.items()]
    assert np.median(gt_errs) < 0.05
    assert (tmp_path / "torch" / "traj" / "track_traj_final.json").exists()
