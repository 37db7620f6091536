"""Keyframe dumps, checkpoint files and trajectory export.

Port of ``super_primitive_tpu/odometry/io.py``, in the same layout and with
the same npz keys, so a checkpoint that either package writes loads in the
other:

  <save_path>/curr_kfs/<tag>/kf_<ts>.npz   one keyframe (``dump_kf``)
  <save_path>/curr_kfs/<tag>/window.txt    the window's timestamps
  <save_path>/traj/kf_traj_<tag>.json      keyframe trajectory
  <save_path>/traj/track_traj_<tag>.json   tracked trajectory
  <save_path>/traj/frame_timestamps_<tag>.json

Everything here is numpy on the host: a checkpoint does not depend on the
device it was written from.  ``export_tum_trajectory`` writes the TUM format
(``t tx ty tz qx qy qz qw``) that external trajectory evaluators read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .window import HostKeyFrame


def dump_kf(path: str, kf: HostKeyFrame) -> None:
    """Write ``kf`` to ``<path>/kf_<timestamp>.npz``."""
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(
        os.path.join(path, f"kf_{kf.timestamp}.npz"),
        timestamp=kf.timestamp, image=np.asarray(kf.image), K=np.asarray(kf.K),
        regions=np.asarray(kf.regions), logdepth_perseg=np.asarray(kf.logdepth_perseg),
        keypoints_rc=np.asarray(kf.keypoints_rc), pose=np.asarray(kf.pose),
        kp_logdepth=np.asarray(kf.kp_logdepth), affine=np.asarray(kf.affine),
    )


def load_kf(path: str, timestamp: str) -> HostKeyFrame:
    """Read the keyframe ``dump_kf`` wrote for ``timestamp``."""
    d = np.load(os.path.join(path, f"kf_{timestamp}.npz"))
    return HostKeyFrame(
        timestamp=str(d["timestamp"]), image=d["image"], K=d["K"], regions=d["regions"],
        logdepth_perseg=d["logdepth_perseg"], keypoints_rc=d["keypoints_rc"],
        pose=d["pose"], kp_logdepth=d["kp_logdepth"], affine=d["affine"],
    )


def save_trajectory(path: str, traj: dict, tag: str, name: str = "kf_traj") -> str:
    """``traj`` maps timestamp string -> 4x4 pose."""
    os.makedirs(path, exist_ok=True)
    fp = os.path.join(path, f"{name}_{tag}.json")
    with open(fp, "w") as f:
        json.dump({ts: np.asarray(T).tolist() for ts, T in traj.items()}, f)
    return fp


def load_trajectory(fp: str) -> dict:
    """The trajectory ``save_trajectory`` wrote: timestamp -> 4x4 array."""
    with open(fp) as f:
        raw = json.load(f)
    return {ts: np.asarray(T) for ts, T in raw.items()}


def export_tum_trajectory(traj: dict, timestamps: dict, out_path: str) -> str:
    """Write a TUM-format trajectory: ``traj`` frame-id string -> 4x4 world
    pose, ``timestamps`` frame-id string -> float dataset timestamp."""
    from scipy.spatial.transform import Rotation

    lines = []
    for fid in sorted(traj.keys(), key=lambda s: int(s)):
        T = np.asarray(traj[fid])
        t = T[:3, 3]
        q = Rotation.from_matrix(T[:3, :3]).as_quat()  # xyzw
        lines.append(f"{timestamps[fid]} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_path
