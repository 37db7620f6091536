"""Convert a run's saved keyframe trajectory to TUM format for external
trajectory evaluators (evo).

    python -m super_primitive_tpu_torch.convert_traj_to_tum --run DIR --config CFG.yaml \
        [--tag final]

The port's counterpart of the repository's ``convert_traj_to_tum.py``: it
reads ``<run>/traj/kf_traj_<tag>.json``, maps frame ids to the dataset's
timestamps through the config's dataset (``run_sfm.load_dataset``: a tree
in the TUM, Replica or VOID layout, or the planes sequence) and writes
``converted_tum_traj.txt`` and, where the dataset has poses,
``converted_gt_tum_traj.txt`` into the run directory.
"""

from __future__ import annotations

import argparse
import os

from .config import load_config
from .odometry.io import export_tum_trajectory, load_trajectory


def convert(run_dir: str, config, tag: str = "final") -> tuple[str, str | None]:
    """Write the run's TUM files; returns their paths (the ground truth's
    None where the dataset has no poses)."""
    from .run_sfm import load_dataset

    traj = load_trajectory(os.path.join(run_dir, "traj", f"kf_traj_{tag}.json"))
    dataset = load_dataset(config, n_frames=max(int(fid) for fid in traj) + 1)
    frames = {fid: dataset[int(fid)] for fid in traj}
    timestamps = {fid: float(f["timestamp"]) for fid, f in frames.items()}
    out_pred = export_tum_trajectory(traj, timestamps,
                                     os.path.join(run_dir, "converted_tum_traj.txt"))
    gt = {fid: f["T"] for fid, f in frames.items() if f.get("T") is not None}
    out_gt = None
    if gt:
        out_gt = export_tum_trajectory(gt, timestamps,
                                       os.path.join(run_dir, "converted_gt_tum_traj.txt"))
    return out_pred, out_gt


def main(argv=None):
    ap = argparse.ArgumentParser(description="write a run's trajectory in TUM format")
    ap.add_argument("--run", required=True, help="run directory (the config's save_path)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--tag", default="final")
    args = ap.parse_args(argv)
    out_pred, out_gt = convert(args.run, load_config(args.config), args.tag)
    print(f"wrote {out_pred}" + (f" and {out_gt}" if out_gt else ""))
    print("evaluate: evo_ape tum converted_gt_tum_traj.txt converted_tum_traj.txt -as")


if __name__ == "__main__":
    main()
