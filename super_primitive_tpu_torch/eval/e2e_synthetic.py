"""Config and entry point of the synthetic end-to-end odometry run.

Port of ``super_primitive_tpu/eval/e2e_synthetic.py``: monocular VO on the
synthetic planes sequence through the structured fake frontend, at the
shapes of the JAX package's e2e workload (480x640 frames, 240x320 keyframe
geometry, SAM at 240x320, window 4, 128 + 32 prompts, the depth split on).
``small=True`` cuts it to 96x128 frames and 48x64 geometry.  With
``solver="gn"`` tracking and mapping take the GN/LM solvers at ``gn_iters``
LM iterations (the JAX package's GN workload: level 2 only, 30 iterations)
and mapping linearizes on every ``point_stride``-th bundle point.
``restore_split=N`` runs to frame N, checkpoints at frame N - 1, and
finishes the sequence in a fresh ``Odometry`` with a fresh frontend that
resumes from the checkpoint (``examples/e2e_planes.py --restore-split``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch


def make_e2e_config(solver: str = "adam", small: bool = False, gn_iters: int = 30,
                    point_stride: int = 1, save_path: str | None = None):
    """The e2e synthetic odometry Config (the JAX package's shapes)."""
    from ..config import load_config

    H, W, pow_ = (96, 128, 0) if small else (480, 640, 1)
    extra = {} if solver == "adam" else {"solver": solver, "gn_max_iters": gn_iters}
    map_extra = dict(extra)
    if solver != "adam":
        map_extra["gn_point_stride"] = point_stride
    return load_config({
        "save_path": save_path or os.path.join(tempfile.gettempdir(), f"sp_e2e_planes_{solver}"),
        "window_size": 4,
        "frontend": {
            "downsample_pow": pow_,
            "num_pts": 128, "num_pts_active": 32,
            "normals": {"integration_shape": [48, 64] if small else [240, 320],
                        "network_dim": [H, W]},
            "cg_max_iter": 300, "cg_tol": 1e-3,
            "check_for_depth_disc": True,
        },
        "sam_params": {"infer_resolution": [96, 128] if small else [240, 320]},
        "aligment": {
            "mono_init": True,
            "affine_compensation": False,
            "opt_supporting": True,
            "init_frames": 3,
            "mapping": {"supp_every_n": 3, "init_steps": 60, "steps": 40,
                        "continual_steps": 5, **map_extra},
            "track": {"pyramid_min": 0, "pyramid_max": 3, "steps": [0, 0, 300], **extra},
        },
        "kf": {"depth_validity_ratio": 0.60, "translation_thresh": 0.08},
    })


def run_e2e(solver: str = "adam", frames: int = 20, small: bool = False,
            n_cells: int | None = None, gn_iters: int = 30, point_stride: int = 1,
            path: str = "auto", device_sam: bool = True, seed: int = 0,
            device: str | torch.device = "cuda", save_path: str | None = None,
            restore_split: int = 0, save_every: int = -1, on_restore=None) -> dict:
    """Run the synthetic sequence end to end on ``device``; returns a stats
    dict: ate (Sim(3) ATE over all tracked frames), wall_s, frames,
    keyframes, kf_add_log, timer (StageTimer), odom (the Odometry object).

    ``restore_split=N`` (3 < N < frames) stops the first run at frame N,
    saves its state at frame N - 1 and resumes it in a fresh Odometry and
    frontend; the dict then also holds ``pre_restore_tracked`` and
    ``post_restore_tracked`` (tracked frames before and after),
    ``first_leg`` (the first Odometry), ``save_s`` and ``load_s`` (the
    timers' ``save_state`` and ``load_state`` stages) and
    ``checkpoint_bytes``.  ``on_restore()``, if given, runs between the
    legs; ``odom``, ``timer`` and ``kf_add_log`` are the second leg's.
    ``save_every`` > 0 checkpoints every that many frames in both legs."""
    from ..config.schema import RestoreConfig
    from ..data.synthetic import PlanesSequence
    from ..frontend.fakes import StructuredFakeFrontend
    from ..odometry.odometry import Odometry
    from ..run_sfm import require_device
    from .trajectory import ate_rmse

    device = require_device(device)
    H, W = (96, 128) if small else (480, 640)
    if n_cells is None:
        n_cells = 24 if small else 64
    if path == "auto":
        path = "orbit" if frames > 40 else "linear"
    cfg = make_e2e_config(solver, small=small, gn_iters=gn_iters, point_stride=point_stride,
                          save_path=save_path)
    cfg = dataclasses.replace(cfg, save_every=save_every)
    ds = PlanesSequence(n_frames=frames, H=H, W=W, path=path)

    def leg(config):
        fe = StructuredFakeFrontend(config, seed=seed, n_cells=n_cells, device=device,
                                    device_sam=device_sam)
        return Odometry(config, fe, ds, device=device)

    extra = {}
    odom = leg(cfg)
    t0 = time.perf_counter()
    if restore_split > 0:
        if not 3 < restore_split < frames:
            raise ValueError(f"restore_split {restore_split} is not inside (3, {frames})")
        odom.run(max_frames=restore_split)
        tag_id = restore_split - 1  # the last frame processed
        tag = odom.id_to_timestamp(tag_id)
        kf_dir = odom.save_state(tag=tag)
        files = [os.path.join(kf_dir, f) for f in os.listdir(kf_dir)] + [
            os.path.join(cfg.save_path, "traj", f"{name}_{tag}.json")
            for name in ("kf_traj", "track_traj", "frame_timestamps")]
        first, n_pre = odom, len(odom.global_track_trajectory)
        if on_restore is not None:
            on_restore()
        odom = leg(dataclasses.replace(
            cfg, restore=RestoreConfig(path=cfg.save_path, frame_id=tag_id)))
        traj = odom.run()
        extra = {"first_leg": first, "pre_restore_tracked": n_pre,
                 "post_restore_tracked": len(odom.global_track_trajectory) - n_pre,
                 "save_s": first.timer.last["save_state"],
                 "load_s": odom.timer.last["load_state"],
                 "checkpoint_bytes": sum(os.path.getsize(f) for f in files)}
    else:
        traj = odom.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    est = {ts: np.asarray(T) for ts, T in odom.global_track_trajectory.items()}
    gt = {ts: np.asarray(ds.poses[int(float(ts))], np.float32) for ts in est}
    return {
        "ate": ate_rmse(gt, est),
        "wall_s": wall,
        "frames": len(ds),
        "keyframes": len(traj),
        "kf_add_log": odom.kf_add_log,
        "timer": odom.timer,
        "odom": odom,
        **extra,
    }
