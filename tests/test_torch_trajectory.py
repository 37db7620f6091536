"""The port's trajectory helpers against the JAX package's (both numpy):
``sorted_by_frame_id`` and ``transfer_scale``, with and without
``anchor_rotation``, on seeded poses.  Bound: 1e-12, float64 throughout."""

import numpy as np
import pytest

from super_primitive_tpu.eval import trajectory as jt
from super_primitive_tpu_torch.eval import trajectory as tt

TOL = 1e-12
SCALE = 0.4


def rodrigues(w) -> np.ndarray:
    th = np.linalg.norm(w)
    k = np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def seeded_poses(n: int = 15, seed: int = 0):
    """(GT, estimate) 4x4 poses: GT on a curve, the estimate GT seen through
    a Sim(3) of scale ``SCALE`` with rotation and translation noise."""
    r = np.random.default_rng(seed)
    A, t = rodrigues(r.normal(size=3)), r.normal(size=3)
    gt, est = [], []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = rodrigues(r.normal(size=3))
        T[:3, 3] = [np.cos(0.3 * i), np.sin(0.2 * i), 0.05 * i]
        E = np.eye(4)
        E[:3, :3] = A @ T[:3, :3] @ rodrigues(r.normal(0, 0.01, 3))
        E[:3, 3] = SCALE * A @ T[:3, 3] + t + r.normal(0, 0.01, 3)
        gt.append(T)
        est.append(E)
    return gt, est


def test_sorted_by_frame_id_equals_jax():
    r = np.random.default_rng(1)
    ids = [f"{i:06d}" for i in r.permutation(40)] + ["100", "7"]
    poses = {k: r.normal(size=(4, 4)) for k in ids}
    got, want = tt.sorted_by_frame_id(poses), jt.sorted_by_frame_id(poses)
    assert got[1] == want[1] == sorted(ids, key=int)
    assert all(g is w for g, w in zip(got[0], want[0]))


@pytest.mark.parametrize("anchor_rotation", [False, True])
def test_transfer_scale_equals_jax(anchor_rotation):
    gt, est = seeded_poses()
    est_before = [e.copy() for e in est]
    got_poses, got = tt.transfer_scale(gt, est, anchor_rotation=anchor_rotation)
    want_poses, want = jt.transfer_scale(gt, est, anchor_rotation=anchor_rotation)
    assert sorted(got) == sorted(want)
    assert ("rot_reanchor" in got) == anchor_rotation
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    assert len(got_poses) == len(want_poses) == len(gt)
    for g, w in zip(got_poses, want_poses):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    # the display alignment lands on GT up to the noise; the inputs stay
    for g, T in zip(got_poses, gt):
        assert np.abs(g[:3, 3] - T[:3, 3]).max() < 0.1
    for e, b in zip(est, est_before):
        np.testing.assert_array_equal(e, b)
    np.testing.assert_allclose(got["s"], 1 / SCALE, rtol=0.05)
