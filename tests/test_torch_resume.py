"""Checkpoints, resume and keyframe dumps of the PyTorch port against the
JAX package (CPU).

Inputs: the rendered plane sequence of ``tests/test_odometry.py`` (48x64,
12 frames, analytic GT depth) through the GT-depth grid stub, window 3,
GT depth init, ``save_every: 4``, the loop of
``test_torch_odometry.py::test_whole_loop`` (Adam) or of
``test_torch_odometry_gn.py`` (GN tracking and mapping at 15 LM iterations,
fused frames).  JAX runs to frame 9 and checkpoints; JAX and the port then
resume from its last checkpoint in a fresh ``Odometry`` and run to the end, with
the longer track schedule of ``tests/test_resume_viz.py`` (the first
resumed frame bridges several frames of motion).  Bounds:

- ``dump_kf`` / ``load_kf`` cross-load both ways with equal arrays;
- the restored window (every ``WindowBuffers`` field) and host keyframes
  equal JAX's exactly, with the capacities of an uninterrupted run and a
  fresh ``Odometry``'s start-up state;
- the post-restore tracks: the same frames as JAX's; with GN every pose
  within 1e-2 in |log| of JAX's and their median within 5e-3; with Adam,
  whose fixed-step iterates never settle, against JAX's resumed run with
  float64 solvers within 3e-2 at the largest and 2e-2 at the median
  (``float64_reference.near_jax_float64``, the bounds of
  ``test_whole_loop``; on the test's frames and twelve copies with 0.1% of
  the pixels one level up, ``tests/torch_diagnostics.py resume --seeds
  12``, JAX's float32 run read up to 8.2e-3 from it and the port's up to
  1.10e-2); against the ground truth the last below 0.12 and the largest
  below 0.2 (``tests/test_resume_viz.py``);
- a checkpoint the port writes restores JAX's window from the same
  keyframes and resumes in JAX within the same ground-truth bounds;
- ``dump_kfs`` writes the keyframe that leaves the window;
- a checkpoint without ``frame_timestamps_<tag>.json`` takes the frame
  timestamps from the dataset.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from float64_reference import jax_float64_solvers, near_jax_float64
from test_odometry import PlaneSequence

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.frontend.stub import GridSegmentFrontend as JGrid
from super_primitive_tpu.keyframe import build_bundle_np as j_bundle
from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu.odometry import io as jio
from super_primitive_tpu.odometry import window as jwin
from super_primitive_tpu.odometry.odometry import Odometry as _JOdometry
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.frontend.stub import GridSegmentFrontend as TGrid
from super_primitive_tpu_torch.odometry import io as tio
from super_primitive_tpu_torch.odometry import window as twin
from super_primitive_tpu_torch.odometry.odometry import Odometry as TOdometry

SPLIT = 9  # the first leg processes frames 0..8
WINDOW_FIELDS = ("images", "K", "poses", "kp_logdepth", "affine", "kf_valid", "uv", "seg_id",
                 "base_logdepth", "point_valid", "num_valid", "kp_base", "supp_valid")
KF_FIELDS = ("image", "K", "regions", "logdepth_perseg", "keypoints_rc", "pose",
             "kp_logdepth", "affine")


class JOdometry(_JOdometry):
    """The JAX package's Odometry with its latest-slot cache tied to the live buffers.

    ``Odometry._last_bundle`` keys its cache on ``id(self.buffers)``. Once
    an old buffers tree is freed, a new tree can get the same id, and the
    tracker then reads a stale slot (the previous kp_logdepth, bundle and
    K). Whether an id is reused depends on the process's allocations, so
    the JAX first leg's checkpoint, and both resumed tracks, changed from
    run to run. Holding the tree the cache was made from rules out the
    reuse, so both JAX legs are deterministic."""

    def _last_bundle(self):
        if getattr(self, "_slot_cache_of", None) is not self.buffers:
            self._slot_cache_of = self.buffers
            self._slot_cache_key = None
        return super()._last_bundle()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops (as in ``test_torch_odometry_gn.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def odom_cfg(load_config, save_path, solver, restore=None, track_steps=250, **extra):
    gn = {"solver": "gn", "gn_max_iters": 15} if solver == "gn" else {}
    return load_config({
        "save_path": str(save_path),
        "save_every": 4,
        "window_size": 3,
        "aligment": {
            "mono_init": False, "affine_compensation": False, "opt_supporting": True,
            "init_frames": 3,
            "mapping": {"supp_every_n": 3, "init_steps": 60, "steps": 40, "continual_steps": 5,
                        **gn},
            "track": {"lr": 5e-3, "pyramid_min": 0, "pyramid_max": 2,
                      "steps": [0, track_steps], **gn},
        },
        "kf": {"depth_validity_ratio": 0.60, "translation_thresh": 0.10},
        **({"restore": restore} if restore else {}),
        **extra,
    })


def resume_cfg(load_config, save_path, solver, ckpt):
    # the resumed leg tracks with test_resume_viz's longer schedule
    return odom_cfg(load_config, save_path, solver, restore=ckpt, track_steps=400)


def pose_err(A, B):
    return float(np.linalg.norm(np.asarray(jse3.log(
        jnp.asarray(np.linalg.inv(A) @ B, jnp.float32)))))


def last_checkpoint(save_path):
    return {"path": str(save_path), "frame_id": int(sorted(os.listdir(save_path / "curr_kfs"))[-1])}


def post_restore(odom, frame_id):
    return {k: T for k, T in odom.global_track_trajectory.items() if int(k) > frame_id}


def assert_window_equal(t_odom, j_odom):
    assert t_odom.num_kfs == j_odom.num_kfs
    for f in WINDOW_FIELDS:
        got = getattr(t_odom.buffers, f)
        got = got if isinstance(got, np.ndarray) else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(j_odom.buffers, f)), err_msg=f)
    for tk, jk in zip(t_odom.host_kfs, j_odom.host_kfs):
        assert tk.timestamp == jk.timestamp
        for f in KF_FIELDS:
            np.testing.assert_array_equal(getattr(tk, f), np.asarray(getattr(jk, f)), err_msg=f)


@pytest.fixture(scope="module")
def seq():
    return PlaneSequence(n_frames=12)


@pytest.fixture(scope="module", params=["adam", "gn"])
def resumed(request, seq, tmp_path_factory):
    """JAX's first leg and checkpoint, then JAX's and the port's resumed runs."""
    solver = request.param
    tmp = tmp_path_factory.mktemp(f"resume_{solver}")
    first = JOdometry(odom_cfg(jload_config, tmp / "first", solver), JGrid(rows=4, cols=5), seq)
    first.run(max_frames=SPLIT)
    ckpt = last_checkpoint(tmp / "first")
    jo = JOdometry(resume_cfg(jload_config, tmp / "jax", solver, ckpt), JGrid(rows=4, cols=5),
                   seq)
    jo.run()
    to = TOdometry(resume_cfg(tload_config, tmp / "torch", solver, ckpt), TGrid(rows=4, cols=5),
                   seq, device="cpu")
    to.run()
    ref = None
    if solver == "adam":
        with jax_float64_solvers():
            ref = JOdometry(resume_cfg(jload_config, tmp / "float64", solver, ckpt),
                            JGrid(rows=4, cols=5), seq)
            ref.run()
    return {"solver": solver, "tmp": tmp, "first": first, "ckpt": ckpt, "jax": jo, "torch": to,
            "float64": ref}


def test_kf_dumps_cross_load(tmp_path):
    r = np.random.default_rng(0)
    regions = r.uniform(size=(5, 12, 16)) > 0.5
    kf = twin.HostKeyFrame(
        timestamp="000042", image=r.uniform(size=(24, 32, 3)).astype(np.float32),
        K=np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]], np.float32), regions=regions,
        logdepth_perseg=r.normal(size=(5, 12, 16)).astype(np.float32),
        keypoints_rc=r.integers(0, 12, (5, 2)), pose=np.eye(4, dtype=np.float32),
        kp_logdepth=r.normal(size=5).astype(np.float32),
        affine=r.normal(size=2).astype(np.float32))
    tio.dump_kf(str(tmp_path / "torch"), kf)
    jio.dump_kf(str(tmp_path / "jax"), jwin.HostKeyFrame(**dataclasses.asdict(kf)))
    from_torch = jio.load_kf(str(tmp_path / "torch"), "000042")
    from_jax = tio.load_kf(str(tmp_path / "jax"), "000042")
    for loaded in (from_torch, from_jax):
        assert loaded.timestamp == "000042"
        for f in KF_FIELDS:
            want = getattr(kf, f)
            got = getattr(loaded, f)
            assert got.dtype == np.asarray(want).dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    traj = {"000001": np.eye(4) * 2.0}
    jio.save_trajectory(str(tmp_path), traj, "t")
    np.testing.assert_array_equal(tio.load_trajectory(str(tmp_path / "kf_traj_t.json"))["000001"],
                                  traj["000001"])


def test_restored_window_equals_jax(resumed, seq):
    """``load_state`` alone, in a fresh ``Odometry`` of each package."""
    tmp, ckpt, solver = resumed["tmp"], resumed["ckpt"], resumed["solver"]
    jo = JOdometry(resume_cfg(jload_config, tmp / "j_load", solver, ckpt), JGrid(rows=4, cols=5),
                   seq)
    jo.load_state(ckpt["path"], ckpt["frame_id"])
    to = TOdometry(resume_cfg(tload_config, tmp / "t_load", solver, ckpt), TGrid(rows=4, cols=5),
                   seq, device="cpu")
    assert to.load_state(ckpt["path"], ckpt["frame_id"]) == ckpt["frame_id"]
    assert_window_equal(to, jo)
    # the capacities of the uninterrupted run, and a fresh Odometry's state
    first = resumed["first"]
    assert (to.seg_cap, to.point_cap) == (jo.seg_cap, jo.point_cap) == (first.seg_cap,
                                                                         first.point_cap)
    assert to.buffers.uv.shape == tuple(first.buffers.uv.shape)
    assert to._kf_pyramid_cache is None and to._last_gate is None and not to._host_ld_dirty
    assert to.tracked == [] and not to.mapping_scheduled and not to.supp_valid_host.any()
    assert to.initialised == jo.initialised
    assert (to.current_ts, to.current_track.tolist()) == (jo.current_ts, jo.current_track.tolist())
    assert to.frame_timestamps == jo.frame_timestamps
    assert sorted(to.global_track_trajectory) == sorted(first.global_track_trajectory)


def test_post_restore_tracks_agree(resumed, seq):
    jo, to, fid = resumed["jax"], resumed["torch"], resumed["ckpt"]["frame_id"]
    jpost, tpost = post_restore(jo, fid), post_restore(to, fid)
    assert sorted(tpost) == sorted(jpost) and len(tpost) >= 3
    assert sorted(to.global_kf_trajectory) == sorted(jo.global_kf_trajectory)
    if resumed["solver"] == "adam":
        near_jax_float64(tpost, jpost, post_restore(resumed["float64"], fid))
    else:
        errs = [pose_err(tpost[k], jpost[k]) for k in jpost]
        assert max(errs) < 1e-2 and np.median(errs) < 5e-3, errs
    gt = [pose_err(tpost[k], seq.poses[int(k)]) for k in sorted(tpost, key=int)]
    assert gt[-1] < 0.12 and max(gt) < 0.2, gt
    if resumed["solver"] == "gn":
        assert to.timer.counts.get("fused_frame", 0) > 0
    # the final TUM export can cover the frames before the restore
    assert set(to.frame_timestamps) >= set(to.global_track_trajectory)
    out = resumed["tmp"] / "torch"
    assert (out / "traj" / "track_traj_final.json").exists()
    assert (out / "curr_kfs" / to.current_ts / "window.txt").exists()


@pytest.fixture(scope="module")
def port_first(seq, tmp_path_factory):
    """The port's own first leg (Adam) and its last checkpoint."""
    tmp = tmp_path_factory.mktemp("port_first")
    to = TOdometry(odom_cfg(tload_config, tmp / "torch", "adam"), TGrid(rows=4, cols=5), seq,
                   device="cpu")
    to.run(max_frames=SPLIT)
    return to, last_checkpoint(tmp / "torch")


def test_port_checkpoint_resumes_in_jax(port_first, seq, tmp_path):
    to, ckpt = port_first
    assert ckpt["frame_id"] == SPLIT - 1
    jo = JOdometry(resume_cfg(jload_config, tmp_path / "jax", "adam", ckpt),
                   JGrid(rows=4, cols=5), seq)
    jo.load_state(ckpt["path"], ckpt["frame_id"])
    # JAX's restored window holds the port's keyframes as they stood
    assert [k.timestamp for k in jo.host_kfs] == [k.timestamp for k in to.host_kfs]
    for i, kf in enumerate(to.host_kfs):
        for f in KF_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jo.host_kfs[i], f)),
                                          getattr(kf, f), err_msg=f)
        b = j_bundle(kf.regions, kf.logdepth_perseg, capacity=jo.point_cap)
        np.testing.assert_array_equal(np.asarray(jo.buffers.uv[i]), np.asarray(b.uv))
        np.testing.assert_array_equal(np.asarray(jo.buffers.poses[i]), kf.pose)
    jo2 = JOdometry(resume_cfg(jload_config, tmp_path / "jax2", "adam", ckpt),
                    JGrid(rows=4, cols=5), seq)
    jo2.run()
    post = post_restore(jo2, ckpt["frame_id"])
    gt = [pose_err(post[k], seq.poses[int(k)]) for k in sorted(post, key=int)]
    assert len(gt) >= 3 and gt[-1] < 0.12 and max(gt) < 0.2, gt


def test_dump_kfs_writes_the_rolled_keyframe(seq, tmp_path):
    cfg = dataclasses.replace(odom_cfg(tload_config, tmp_path, "adam", dump_kfs=True),
                              window_size=2)
    to = TOdometry(cfg, TGrid(rows=4, cols=5), seq, device="cpu")
    for i in (0, 3, 6):
        to.current_track = seq.poses[i].astype(np.float32)
        if i == 6:
            leaving = to.host_kfs[0]
            assert not (tmp_path / "curr_kfs").exists()
        to.init_keyframe(seq[i], to.current_track, to.id_to_timestamp(i))
    assert [k.timestamp for k in to.host_kfs] == ["000003", "000006"]
    assert sorted(os.listdir(tmp_path / "curr_kfs")) == ["kf_000000.npz"]
    dumped = tio.load_kf(str(tmp_path / "curr_kfs"), "000000")
    for f in KF_FIELDS:
        np.testing.assert_array_equal(getattr(dumped, f), getattr(leaving, f), err_msg=f)


def test_frame_timestamps_fallback(port_first, seq, tmp_path):
    ckpt = port_first[1]
    old = tmp_path / "ckpt"
    shutil.copytree(ckpt["path"], old)
    tag = str(ckpt["frame_id"]).zfill(6)
    with_file = TOdometry(resume_cfg(tload_config, tmp_path / "a", "adam", ckpt),
                          TGrid(rows=4, cols=5), seq, device="cpu")
    with_file.load_state(str(old), ckpt["frame_id"])
    os.remove(old / "traj" / f"frame_timestamps_{tag}.json")
    without = TOdometry(resume_cfg(tload_config, tmp_path / "b", "adam", ckpt),
                        TGrid(rows=4, cols=5), seq, device="cpu")
    without.load_state(str(old), ckpt["frame_id"])
    keys = set(without.global_kf_trajectory) | set(without.global_track_trajectory)
    assert set(without.frame_timestamps) == keys
    assert without.frame_timestamps == {k: float(seq[int(k)]["timestamp"]) for k in keys}
    assert all(with_file.frame_timestamps[k] == v for k, v in without.frame_timestamps.items())
