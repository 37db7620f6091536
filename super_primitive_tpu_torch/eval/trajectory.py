"""Trajectory alignment + ATE evaluation (numpy).

Port of ``super_primitive_tpu/eval/trajectory.py`` (``horn_align`` and
``ate_rmse``): Horn closed-form alignment with scale, the classic TUM
rgbd-benchmark routine, and the Sim(3) ATE RMSE of the evo_ape protocol,
self-contained so no external evaluator is needed.
"""

from __future__ import annotations

import numpy as np


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
