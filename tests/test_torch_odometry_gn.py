"""The GN odometry loop of the PyTorch port against the JAX package (CPU).

The configuration of ``tests/test_odometry.py``'s GN fixture: the rendered
plane sequence (48x64, 12 frames, analytic GT depth) through the GT-depth
grid stub, window 3, GT depth init, GN tracking and GN mapping at 15 LM
iterations, so every tracked frame after the first keyframe takes the fused
step.  Bounds:

- the same keyframe timestamps as JAX;
- every tracked pose within 1e-2 in |log| of JAX's and their median within
  5e-3 (the bounds of ``test_torch_odometry.py::test_whole_loop``: LM paths
  part on float32 noise, as run to run on the CPU);
- the fused step ran and no separate supp mapping did; the host mirror of
  the supporting slots equals the device's; the host keyframes' log-depths
  equal the window's after the run (the lazy refresh);
- the port's GN track ATE at most 1.1x the port's Adam ATE on the same
  frames (``tests/test_odometry.py::TestSolverEquivalence``).
"""

import numpy as np
import pytest
import torch
from test_odometry import PlaneSequence

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.frontend.stub import GridSegmentFrontend as JGrid
from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu.odometry.odometry import Odometry as JOdometry
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.eval.trajectory import ate_rmse
from super_primitive_tpu_torch.frontend.stub import GridSegmentFrontend as TGrid
from super_primitive_tpu_torch.odometry.odometry import Odometry as TOdometry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: beside the other test workers, torch's thread
    pool spends more time waiting on its own threads than computing, so
    this module runs on one (restored after it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def odom_cfg(load_config, save_path, solver):
    gn = {"solver": "gn", "gn_max_iters": 15} if solver == "gn" else {}
    return load_config({
        "save_path": str(save_path),
        "window_size": 3,
        "aligment": {
            "mono_init": False, "affine_compensation": False, "opt_supporting": True,
            "init_frames": 3,
            "mapping": {"supp_every_n": 3, "init_steps": 60, "steps": 40, "continual_steps": 5,
                        **gn},
            "track": {"lr": 5e-3, "pyramid_min": 0, "pyramid_max": 2, "steps": [0, 250], **gn},
        },
        "kf": {"depth_validity_ratio": 0.60, "translation_thresh": 0.10},
    })


def pose_err(A, B):
    import jax.numpy as jnp

    return float(np.linalg.norm(np.asarray(jse3.log(
        jnp.asarray(np.linalg.inv(A) @ B, jnp.float32)))))


def track_ate(seq, odom):
    tr = odom.global_track_trajectory
    return ate_rmse({k: seq.poses[int(k)] for k in tr}, tr)["rmse"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    seq = PlaneSequence(n_frames=12)
    tmp = tmp_path_factory.mktemp("odom_gn")
    jo = JOdometry(odom_cfg(jload_config, tmp / "jax", "gn"), JGrid(rows=4, cols=5), seq)
    jo.run()
    to = TOdometry(odom_cfg(tload_config, tmp / "torch", "gn"), TGrid(rows=4, cols=5), seq,
                   device="cpu")
    to.run()
    return seq, jo, to, tmp


def test_keyframes_and_tracks_match_jax(runs):
    seq, jo, to, tmp = runs
    assert sorted(to.global_kf_trajectory) == sorted(jo.global_kf_trajectory)
    assert len(to.global_kf_trajectory) >= 2 and to.num_kfs <= 3
    assert sorted(to.global_track_trajectory) == sorted(jo.global_track_trajectory)
    assert len(to.global_track_trajectory) == len(seq) - 1
    errs = [pose_err(to.global_track_trajectory[k], jo.global_track_trajectory[k])
            for k in jo.global_track_trajectory]
    assert max(errs) < 1e-2 and np.median(errs) < 5e-3, errs
    assert (tmp / "torch" / "traj" / "track_traj_final.json").exists()


def test_fused_path_and_host_mirrors(runs):
    _, _, to, _ = runs
    counts = to.timer.counts
    assert counts.get("fused_frame", 0) > 0 and counts.get("mapping_supp", 0) == 0
    assert counts.get("track", 0) == 0  # GT init: initialised before frame 1
    # the fused step reads from the card once a frame, and once per LM
    # iteration of its solvers
    reads = to.timer.syncs["fused_frame"]
    lm = sum(to.gn_iters["track"]) + sum(to.gn_iters["supp"])
    assert reads == counts["fused_frame"] + lm, (reads, lm)
    assert to.gn_iters["map"] and all(1 <= n <= 15 for n in to.gn_iters["map"])
    np.testing.assert_array_equal(to.supp_valid_host, to.buffers.supp_valid.numpy())
    for i, kf in enumerate(to.host_kfs):
        n = kf.kp_logdepth.shape[0]
        np.testing.assert_array_equal(kf.kp_logdepth, to.buffers.kp_logdepth[i, :n].numpy())


def test_gn_track_ate_within_10pct_of_adam(runs):
    seq, _, to, tmp = runs
    adam = TOdometry(odom_cfg(tload_config, tmp / "adam", "adam"), TGrid(rows=4, cols=5), seq,
                     device="cpu")
    adam.run()
    ate_g, ate_a = track_ate(seq, to), track_ate(seq, adam)
    assert ate_g <= 1.1 * ate_a, (ate_g, ate_a)


def test_solvers_other_than_adam_and_gn_raise():
    cfg = odom_cfg(tload_config, "unused", "gn")
    cfg.alignment.track.solver = "lbfgs"
    with pytest.raises(ValueError, match="unknown solver"):
        TOdometry(cfg, TGrid(rows=4, cols=5), PlaneSequence(n_frames=2), device="cpu")


def test_tf32_is_off_after_building(monkeypatch):
    """``Odometry`` (as ``frontend_from_state_dicts``, tested in
    ``test_torch_nets_frontend.py``) turns TF32 off for cuBLAS and cuDNN."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    TOdometry(odom_cfg(tload_config, "unused", "adam"), TGrid(rows=4, cols=5),
              PlaneSequence(n_frames=2), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
