"""Trajectory files.

Port of ``super_primitive_tpu/odometry/io.py`` (``save_trajectory`` and
``export_tum_trajectory``; the keyframe dumps serve checkpoints, which are
not ported): JSON trajectories under ``<save_path>/traj/`` and the
TUM-format export (``t tx ty tz qx qy qz qw``) that external trajectory
evaluators read.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_trajectory(path: str, traj: dict, tag: str, name: str = "kf_traj") -> str:
    """``traj`` maps timestamp string -> 4x4 pose."""
    os.makedirs(path, exist_ok=True)
    fp = os.path.join(path, f"{name}_{tag}.json")
    with open(fp, "w") as f:
        json.dump({ts: np.asarray(T).tolist() for ts, T in traj.items()}, f)
    return fp


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
