"""SfM and odometry runner of the PyTorch port.

Mirrors the repository's ``run_sfm.py``:

    python -m super_primitive_tpu_torch.run_sfm --config CFG.yaml --fake-frontend
    python -m super_primitive_tpu_torch.run_sfm --config CFG.yaml --stub-frontend
    python -m super_primitive_tpu_torch.run_sfm --config CFG.yaml --fake-frontend --odom \
        [--max-frames N]
    python -m super_primitive_tpu_torch.run_sfm --config CFG.yaml \
        --sam-ckpt sam.npz --nnet-ckpt nnet.npz [--odom]

It runs on the card (``--device cuda``, the default) and raises if there is
none; ``--device cpu`` runs the same code on the CPU with the kernels' plain
versions.  The datasets are the synthetic planes scenes (``dataset.type:
planes``, ``dataset.path`` naming the trajectory, ``linear`` or ``orbit``,
at ``frontend.normals.network_dim``) and trees in the TUM, Replica and VOID
layouts (``dataset.type: tum | tum_undistort | replica | void``,
``dataset.path`` the tree, ``traj_file`` TUM's ground truth,
``intrinsics`` an optional (fx, fy, cx, cy)).  Two-frame
SfM writes ``two_frame_result.npz``, the source keyframe's cloud
``src_pointcloud.ply`` and ``viewer.html`` (an interactive viewer whose
points pick their segment) under the config's ``save_path``.  ``--odom``
runs monocular odometry over ``--max-frames`` frames (default 20) and
writes ``converted_tum_traj.txt``, ``viewer.html`` (the final window's
clouds and the tracked path) and, with three or more ground-truth
keyframes, ``converted_gt_tum_traj.txt`` and ``trajectory.png`` there, and
prints the Sim(3) ATE of the keyframe trajectory.  A config's ``restore:``
resumes from a checkpoint, ``save_every:`` writes them, ``dump_kfs:`` keeps
each keyframe that leaves the window.  ``--live-viz DIR`` publishes live
snapshots to DIR (every frame, or every ``--live-every`` Adam iterations
of two-frame SfM); ``python -m super_primitive_tpu_torch.viz.serve DIR``
serves them with a pause button.  With
``--fake-frontend`` odometry takes the device SAM selection
(``DeviceFakeSAM``); two-frame SfM keeps the host FakeSAM.  With
``--sam-ckpt`` and ``--nnet-ckpt`` (the ``.npz`` trees that
``convert_checkpoints.py`` writes) both take the real SAM and NNET
(``frontend.process_frame.build_frontend``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import load_config
from .cost import photometric as ph
from .keyframe import KeyFrame, build_bundle_np, keyframe_pyramid, make_segment_geometry
from .lie import se3
from .solve.two_frame import (
    TwoFrameConfig,
    random_depth_seeds,
    solve_two_frame,
    solve_two_frame_gn,
)
from .utils.numerics import float32_matmuls, settle_cpu_exp
from .utils.timing import to_host
from .viz.export import keyframe_pointcloud, save_ply, save_trajectory_plot
from .viz.live import LiveViz
from .viz.viewer import save_html_viewer


def require_device(device: str | torch.device) -> torch.device:
    """The device to run on, checked, with TF32 off for float32 geometry
    and, on the CPU, ``exp`` settled (``utils.numerics.settle_cpu_exp``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found (pass --device cpu to run on the CPU)")
    float32_matmuls()
    if device.type == "cpu":
        settle_cpu_exp()
    return device


def load_dataset(config, n_frames: int | None = None):
    """The dataset a config names: ``planes`` (a synthetic PlanesSequence
    of ``n_frames`` frames, by default enough for source and target), or a
    real-data tree of ``tum``, ``tum_undistort``, ``replica`` or ``void``
    layout (``data.load_dataset``)."""
    ds = config.dataset
    if ds.type != "planes":
        from .data import load_dataset as load_real

        return load_real(ds)
    from .data.synthetic import PlanesSequence

    H, W = config.frontend.normals.network_dim
    if n_frames is None:
        n_frames = max(ds.source_id, ds.target_id) + 1
    return PlanesSequence(n_frames=n_frames, H=H, W=W, path=ds.path or "linear")


def build_frontend(args, config, device, device_sam: bool = False):
    if args.stub_frontend:
        from .frontend.stub import GridSegmentFrontend

        return GridSegmentFrontend(
            rows=args.stub_rows, cols=args.stub_cols,
            downsample_pow=config.frontend.downsample_pow,
        )
    if args.fake_frontend:
        from .frontend.fakes import StructuredFakeFrontend

        return StructuredFakeFrontend(config, n_cells=64, device=device,
                                      device_sam=device_sam)
    if not (args.sam_ckpt and args.nnet_ckpt):
        raise ValueError("pass --sam-ckpt and --nnet-ckpt (converted .npz trees), "
                         "--fake-frontend or --stub-frontend")
    from .convert import load_npz_tree
    from .frontend.process_frame import build_frontend as build_real_frontend

    return build_real_frontend(config, load_npz_tree(args.sam_ckpt),
                               load_npz_tree(args.nnet_ckpt), device=device)


def window_clouds(odom, with_seg: bool = False) -> dict:
    """The odometry window's keyframes as world-frame coloured clouds,
    {kfN: (points, colors[, seg_ids])}, read off the device with one host
    copy a field; ``with_seg`` adds each point's segment id for the
    viewer's segment picker."""
    b, n = odom.buffers, odom.num_kfs
    uv, seg, base, valid, kp_ld, kp_base, images, K, poses = (
        to_host(x[:n]) for x in (b.uv, b.seg_id, b.base_logdepth, b.point_valid,
                                 b.kp_logdepth, b.kp_base, b.images, b.K, b.poses))
    clouds = {}
    for i in range(n):
        logd = base[i] + (kp_ld[i] - kp_base[i])[seg[i]]
        img = images[i]
        pix = np.clip(np.round(uv[i, :, 1]).astype(int) * img.shape[1]
                      + np.round(uv[i, :, 0]).astype(int), 0, img.shape[0] * img.shape[1] - 1)
        cols = img.reshape(-1, img.shape[-1])[:, :3][pix]
        pts, _ = keyframe_pointcloud(uv[i], np.exp(logd), K[i], poses[i], valid=valid[i])
        clouds[f"kf{i}"] = ((pts, cols[valid[i]], seg[i][valid[i]]) if with_seg
                            else (pts, cols[valid[i]]))
    return clouds


def track_positions(odom) -> np.ndarray:
    """The tracked camera centres in frame order, (M, 3)."""
    return np.asarray([np.asarray(T)[:3, 3] for _, T in sorted(
        odom.global_track_trajectory.items(), key=lambda kv: int(kv[0]))])


def make_odometry_live_cb(live_dir: str):
    """The odometry loop's per-frame live hook: publish the window's clouds
    and the tracked path, then wait while the pause marker exists."""
    lv = LiveViz(live_dir, title="odometry (live)")

    def cb(odom, frame_id):
        traj = track_positions(odom)
        lv.update(window_clouds(odom),
                  trajectories={"track": traj} if len(traj) >= 2 else None,
                  label=f"frame {frame_id} | {odom.num_kfs} KFs")
        paused = lv.checkpoint()
        if paused > 0.5:
            print(f"[live] paused {paused:.1f}s", flush=True)

    return cb


def make_pyramids(config, kf_data: dict, supp: dict, device):
    """Source keyframe (segment geometry + point bundle) and target frame
    pyramids on ``device`` from the frontend's host dicts."""
    regions = kf_data["regions"]
    geo = make_segment_geometry(
        2.0 * kf_data["keypoints_rc"] / (np.asarray(regions.shape[1:]) - 1) - 1.0,
        regions, kf_data["logdepth_perseg"], device=device,
    )
    bundle = build_bundle_np(regions, kf_data["logdepth_perseg"], device=device)

    def tensor(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    src_kf = KeyFrame(image=tensor(kf_data["image"]), K=tensor(kf_data["K"]),
                      K_img=tensor(kf_data["K"]), geo=geo)
    trg_kf = KeyFrame(image=tensor(supp["image"]), K=tensor(supp["K"]),
                      K_img=tensor(supp["K"]))
    lo, hi = config.alignment.pyramid_min, config.alignment.pyramid_max
    return (keyframe_pyramid(src_kf, lo, hi, bundle=bundle),
            keyframe_pyramid(trg_kf, lo, hi))


def run_two_frame(config, frontend, dataset, device="cuda",
                  solve_cfg: TwoFrameConfig = TwoFrameConfig(), live_dir: str | None = None,
                  live_every: int = 50) -> dict:
    """Frontend on the source frame, then the coarse-to-fine solve for the
    target frame's pose and the per-segment depths: retraction Adam
    (``solve_cfg``), or GN/LM when ``alignment.mapping.solver`` is ``gn``
    (``solve_two_frame_gn`` with ``alignment.mapping.gn_max_iters``
    iterations a level, as odometry's mapping solver is chosen).

    Init: the ground-truth relative pose times exp of N(0, 0.05^2) noise
    from a seed-42 generator; depth seeds from a seed-43 generator.  Writes
    ``two_frame_result.npz``, ``src_pointcloud.ply`` and ``viewer.html``
    under ``config.save_path`` and returns the result with its timings and
    pose errors; ``losses`` holds each level's loss history (Adam) or its
    (initial, final) cost (GN).  With ``live_dir`` the Adam solve publishes
    the source cloud there every ``live_every`` iterations."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    src = dataset[config.dataset.source_id]
    trg = dataset[config.dataset.target_id]
    observe = getattr(frontend, "observe", None)
    if observe:
        observe(src)
    sync()
    t0 = time.perf_counter()
    kf_data = frontend.process_to_kf(src["image"], src["intrinsics"])
    supp = frontend.process_to_supp_kf(trg["image"], trg["intrinsics"])
    sync()
    frontend_s = time.perf_counter() - t0

    src_pyr, trg_pyr = make_pyramids(config, kf_data, supp, device)
    geo = src_pyr.geo

    T_rel = np.linalg.inv(trg["T"]) @ src["T"]
    T_rel_t = torch.from_numpy(T_rel.astype(np.float32)).to(device)
    noise = se3.random(torch.Generator().manual_seed(42),
                       sigma=solve_cfg.pose_noise_sigma, device=device)
    T_init = T_rel_t @ noise
    ld0 = random_depth_seeds(torch.Generator().manual_seed(43), geo.num_segments,
                             solve_cfg, device=device)

    bundle, kp_base = src_pyr.bundle, geo.keypoint_base_logdepth()
    uv, valid = to_host(bundle.uv), to_host(bundle.valid)

    def src_cloud(kp_logdepth):
        logd = to_host(ph.spread_logdepth(bundle, kp_logdepth.detach(), kp_base))
        return keyframe_pointcloud(uv, np.exp(logd), kf_data["K"], np.eye(4), valid=valid)[0]

    snapshot_cb = None
    if live_dir:
        lv = LiveViz(live_dir, title="two-frame SfM (live)")

        def snapshot_cb(level, iters_done, params, chunk_losses):
            lv.update({"src": (src_cloud(params.kp_logdepth), None)},
                      label=f"level {level} iter {iters_done}",
                      loss=float(to_host(chunk_losses[-1])))
            lv.checkpoint()

    solver = config.alignment.mapping.solver
    sync()
    t0 = time.perf_counter()
    if solver == "gn":
        if live_dir:
            print("[live] note: per-iteration snapshots are an Adam-path feature; the GN "
                  "solve publishes no live frames")
        poses, ld, gn_losses = solve_two_frame_gn(
            src_pyr, [trg_pyr], T_init[None], ld0,
            max_iters=config.alignment.mapping.gn_max_iters)
        losses = [torch.tensor(pair) for pair in gn_losses]
    elif solver == "adam":
        poses, ld, losses = solve_two_frame(src_pyr, [trg_pyr], T_init[None], ld0, solve_cfg,
                                            snapshot_cb=snapshot_cb,
                                            snapshot_every=max(1, live_every) if live_dir else 0)
    else:
        raise ValueError(f"unknown solver {solver!r}; use adam or gn")
    sync()
    solve_s = time.perf_counter() - t0

    def pose_err(T):
        return float(torch.linalg.norm(se3.log(se3.inverse(T_rel_t) @ T)))

    result = {
        "pose": poses[0].cpu().numpy(),
        "kp_logdepth": ld.cpu().numpy(),
        "losses": [l.cpu().numpy() for l in losses],
        "T_rel_gt": T_rel,
        "T_init": T_init.cpu().numpy(),
        "pose_err_init": pose_err(T_init),
        "pose_err_final": pose_err(poses[0]),
        "num_segments": geo.num_segments,
        "solver": solver,
        "frontend_s": frontend_s,
        "solve_s": solve_s,
    }
    result["final_loss"] = float(result["losses"][-1][-1])
    out = config.save_path
    os.makedirs(out, exist_ok=True)
    pts = src_cloud(ld)
    save_ply(os.path.join(out, "src_pointcloud.ply"), pts)
    save_html_viewer(os.path.join(out, "viewer.html"),
                     {"src": (pts, None, to_host(bundle.seg_id)[valid])},
                     title="two-frame SfM result (click a point to pick its segment)")
    np.savez(
        os.path.join(out, "two_frame_result.npz"),
        pose=result["pose"], kp_logdepth=result["kp_logdepth"],
        losses=result["losses"][-1], T_rel_gt=T_rel,
    )
    return result


def run_odometry(config, frontend, dataset, max_frames=None, device="cuda",
                 live_dir: str | None = None) -> dict:
    """Monocular odometry over ``dataset``; writes ``viewer.html``, the TUM
    trajectories and ``trajectory.png``, and returns the Sim(3) ATE of the
    keyframe trajectory (None with fewer than three ground-truth poses)
    beside the Odometry object.  With ``live_dir`` every frame publishes a
    live snapshot there."""
    from .eval.trajectory import ate_rmse
    from .odometry.io import export_tum_trajectory
    from .odometry.odometry import Odometry

    odom = Odometry(config, frontend, dataset, device=device)
    if live_dir:
        odom.live_cb = make_odometry_live_cb(live_dir)
        print(f"[live] serve with: python -m super_primitive_tpu_torch.viz.serve {live_dir}"
              "  ->  http://localhost:8765/live.html", flush=True)
    traj = odom.run(max_frames=max_frames)
    out = config.save_path
    tp = track_positions(odom)
    save_html_viewer(os.path.join(out, "viewer.html"), window_clouds(odom, with_seg=True),
                     trajectories={"track": tp} if len(tp) >= 2 else None,
                     title="odometry final window (click a point to pick its segment)")
    export_tum_trajectory(traj, odom.frame_timestamps,
                          os.path.join(out, "converted_tum_traj.txt"))
    gt_traj = {}
    for ts in traj:
        T = dataset[int(ts)].get("T")
        if T is not None:
            gt_traj[ts] = T
    ate = None
    if len(gt_traj) >= 3:
        export_tum_trajectory(gt_traj, odom.frame_timestamps,
                              os.path.join(out, "converted_gt_tum_traj.txt"))
        ate = ate_rmse(gt_traj, traj, align_scale=True)
        print(f"ATE RMSE (Sim3): {ate['rmse']:.4f} m over {ate['n']} KFs "
              f"(scale {ate['scale']:.3f})")
        save_trajectory_plot(os.path.join(out, "trajectory.png"),
                             {"estimate": traj, "gt": gt_traj})
    else:
        print(f"no ATE: {len(gt_traj)} keyframes with ground truth, the Sim(3) "
              "alignment needs 3")
    print(f"artifacts in {out}")
    return {"odom": odom, "ate": ate}


def main(argv=None) -> dict:
    """Run the CLI; returns ``run_odometry``'s or ``run_two_frame``'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--odom", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--sam-ckpt", default=None, help=".npz converted SAM tree")
    ap.add_argument("--nnet-ckpt", default=None, help=".npz converted NNET tree")
    ap.add_argument("--stub-frontend", action="store_true")
    ap.add_argument("--stub-rows", type=int, default=6)
    ap.add_argument("--stub-cols", type=int, default=8)
    ap.add_argument("--fake-frontend", action="store_true",
                    help="the structured fake SAM/NNET through the real frontend")
    ap.add_argument("--live-viz", default=None, metavar="DIR",
                    help="write live snapshots (live.html + live.json) to DIR; serve them "
                         "with `python -m super_primitive_tpu_torch.viz.serve DIR`")
    ap.add_argument("--live-every", type=int, default=50,
                    help="two-frame Adam solve: a live snapshot every N iterations (each "
                         "costs host reads)")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    config = load_config(args.config)
    if args.odom:
        dataset = load_dataset(config, n_frames=args.max_frames or 20)
        frontend = build_frontend(args, config, device, device_sam=True)
        return run_odometry(config, frontend, dataset, args.max_frames, device,
                            live_dir=args.live_viz)
    dataset = load_dataset(config)
    frontend = build_frontend(args, config, device)
    r = run_two_frame(config, frontend, dataset, device, live_dir=args.live_viz,
                      live_every=args.live_every)
    print(f"two-frame SfM ({r['solver']}) done on {device}: {r['num_segments']} segments, "
          f"final loss {r['final_loss']:.5f}, pose err |log| "
          f"{r['pose_err_init']:.4f} -> {r['pose_err_final']:.4f}, "
          f"frontend {r['frontend_s']:.2f} s, solve {r['solve_s']:.2f} s")
    print(f"artifacts in {config.save_path}")
    return r


if __name__ == "__main__":
    main()
