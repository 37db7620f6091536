"""The slice as a whole: ``run_e2e("adam", small=True)`` and
``run_e2e("gn", small=True)`` of the PyTorch port against the JAX
package's, on the CPU.

Monocular VO on the synthetic planes sequence (96x128 frames, 48x64
geometry, window 4, mono init) through the structured fake frontend with
the device SAM selection (K3's plain version on the CPU) and the depth split on,
for the 5 frames that give two keyframes.  Bounds: the same keyframe
timestamps and a Sim(3) ATE over the tracked frames within max(10 %, 2e-3)
of JAX's.  The GN run (30 LM iterations, the mono init's GN mapping with
the scale gauge pinned, fused frames after it) also shows the fused step
ran.

The file takes about 50 s alone and several minutes beside the other test
workers, so it is marked slow; ``tests/test_torch_odometry.py`` is the
quick guard of the loop.
"""

import numpy as np
import pytest

from super_primitive_tpu.data.synthetic import PlanesSequence as JPlanes
from super_primitive_tpu.eval.e2e_synthetic import make_e2e_config as j_config
from super_primitive_tpu.eval.trajectory import ate_rmse
from super_primitive_tpu.frontend.fakes import StructuredFakeFrontend as JFrontend
from super_primitive_tpu.odometry.odometry import Odometry as JOdometry
from super_primitive_tpu_torch.eval.e2e_synthetic import run_e2e
from super_primitive_tpu_torch.ops import phase_counts

pytestmark = pytest.mark.slow

FRAMES = 5


def jax_e2e(save_path, solver="adam"):
    """The JAX package's run_e2e(solver, small=True), with its outputs under
    ``save_path``."""
    cfg = j_config(solver, small=True, save_path=str(save_path))
    ds = JPlanes(n_frames=FRAMES, H=96, W=128, path="linear")
    odom = JOdometry(cfg, JFrontend(cfg, seed=0, n_cells=24, device_sam=True), ds)
    traj = odom.run()
    est = dict(odom.global_track_trajectory)
    gt = {ts: np.asarray(ds.poses[int(ts)], np.float32) for ts in est}
    return {"ate": ate_rmse(gt, est), "keyframes": sorted(traj)}


def test_e2e_small_matches_jax(tmp_path):
    want = jax_e2e(tmp_path / "jax")
    phase_counts.reset_launch_counts()
    got = run_e2e("adam", frames=FRAMES, small=True, device="cpu",
                  save_path=str(tmp_path / "torch"))
    assert phase_counts.launch_counts["phase_counts"] == 0  # plain K3 on the CPU
    assert sorted(got["odom"].global_kf_trajectory) == want["keyframes"]
    assert got["keyframes"] == len(want["keyframes"]) == 2
    a, b = got["ate"]["rmse"], want["ate"]["rmse"]
    assert np.isfinite(a) and abs(a - b) <= max(0.1 * b, 2e-3), (a, b)
    assert got["timer"].counts["split"] == 2 and got["timer"].counts["sam_round1"] == 2
    assert (tmp_path / "torch" / "traj" / "track_traj_final.json").exists()


def test_e2e_small_gn_matches_jax(tmp_path):
    want = jax_e2e(tmp_path / "jax", solver="gn")
    got = run_e2e("gn", frames=FRAMES, small=True, device="cpu",
                  save_path=str(tmp_path / "torch"))
    assert sorted(got["odom"].global_kf_trajectory) == want["keyframes"]
    assert got["keyframes"] == len(want["keyframes"]) >= 2
    a, b = got["ate"]["rmse"], want["ate"]["rmse"]
    assert np.isfinite(a) and abs(a - b) <= max(0.1 * b, 2e-3), (a, b)
    counts = got["timer"].counts
    assert counts["mapping_init"] == 1 and counts.get("mapping_supp", 0) == 0
    assert counts["fused_frame"] >= 1
