"""Trajectory alignment + ATE evaluation (numpy).

Port of ``super_primitive_tpu/eval/trajectory.py``: Horn closed-form
alignment with scale, the classic TUM rgbd-benchmark routine, the scale
transfer for monocular display (``transfer_scale``), and the Sim(3) ATE
RMSE of the evo_ape protocol, self-contained so no external evaluator is
needed.
"""

from __future__ import annotations

import numpy as np


def sorted_by_frame_id(pose_dict: dict):
    """(poses, frame ids) of ``pose_dict`` in the order of the ids as
    integers (pose_utils.py:7-14)."""
    items = sorted(pose_dict.items(), key=lambda kv: int(kv[0]))
    return [p for _, p in items], [k for k, _ in items]


def horn_align(model: np.ndarray, data: np.ndarray) -> dict:
    """Horn closed-form alignment of 3xN trajectories (pose_utils.py:71-133).

    Returns rot, trans (unscaled), trans_scaled (with scale s), per-point
    errors for both, and the aligned models.
    """
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    model_c = model - model.mean(1, keepdims=True)
    data_c = data - data.mean(1, keepdims=True)

    W = model_c @ data_c.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh

    rotmodel = rot @ model_c
    dots = float(np.sum(data_c * rotmodel))
    norms = float(np.sum(model_c * model_c))
    s = dots / norms

    trans_scaled = data.mean(1, keepdims=True) - s * rot @ model.mean(1, keepdims=True)
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)

    aligned_scaled = s * rot @ model + trans_scaled
    aligned = rot @ model + trans

    return {
        "rot": rot,
        "trans": trans,
        "trans_scaled": trans_scaled,
        "s": s,
        "model_aligned_scaled": aligned_scaled,
        "model_aligned": aligned,
        "trans_scaled_error": np.sqrt(np.sum((aligned_scaled - data) ** 2, axis=0)),
        "trans_error": np.sqrt(np.sum((aligned - data) ** 2, axis=0)),
    }


def transfer_scale(gt_poses, est_poses, anchor_rotation=False):
    """Sim(3)-align estimated 4x4 poses onto GT for display
    (pose_utils.py:16-48): translations Horn-aligned with scale, rotations
    re-anchored to the first GT rotation.  Returns (aligned poses, the
    ``horn_align`` result, with ``rot_reanchor`` when ``anchor_rotation``)."""
    gt_poses = [np.asarray(p, np.float64).copy() for p in gt_poses]
    est_poses = [np.asarray(p, np.float64).copy() for p in est_poses]
    R0_gt = gt_poses[0][:3, :3].copy()
    R0_est = est_poses[0][:3, :3].copy()

    gt_t = np.stack([p[:3, 3] for p in gt_poses], axis=1)
    est_t = np.stack([p[:3, 3] for p in est_poses], axis=1)
    result = horn_align(est_t, gt_t)

    for i, pose in enumerate(est_poses):
        pose[:3, 3] = result["model_aligned_scaled"][:, i]
        pose[:3, :3] = R0_gt @ R0_est.T @ pose[:3, :3]
    if anchor_rotation:
        result["rot_reanchor"] = R0_gt @ R0_est.T
    return est_poses, result


def ate_rmse(gt_traj: dict, est_traj: dict, align_scale: bool = True) -> dict:
    """Sim(3)- (or SE(3)-) aligned absolute trajectory error over matching
    frame ids — the evo_ape protocol the reference delegates to."""
    common = sorted(set(gt_traj) & set(est_traj), key=lambda s: int(s))
    if len(common) < 3:
        raise ValueError(f"only {len(common)} common poses")
    gt = np.stack([np.asarray(gt_traj[k])[:3, 3] for k in common], axis=1)
    est = np.stack([np.asarray(est_traj[k])[:3, 3] for k in common], axis=1)
    result = horn_align(est, gt)
    err = result["trans_scaled_error" if align_scale else "trans_error"]
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "max": float(err.max()),
        "n": len(common),
        "scale": result["s"],
    }
