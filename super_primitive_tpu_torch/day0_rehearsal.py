"""Day-0 rehearsal: the pipeline from the published checkpoints and a TUM
sequence to an ATE, end to end, on synthetic files in the published
formats.

    python -m super_primitive_tpu_torch.day0_rehearsal [--dir DIR] [--keep]
        [--frames N] [--device cuda|cpu] [--full-size]

The port's counterpart of the root ``day0_rehearsal.py``.  It writes

    models/sam_vit_h_4b8939.pth     (synthetic tiny SAM, published names)
    models/scannet.pth              ({"model": {"module.*": ...}}, as published)
    datasets/TUM_fr1/rgbd_dataset_freiburg1_desk/   (TUM layout)
    datasets/void_release/                          (VOID layout)

and then runs what a user holding the real files runs:

    1. ``convert_checkpoints --sam ... --nnet ... --validate --sam-cfg tiny``;
    2. one forward of each converted tree through ``build_frontend``: SAM's
       statistics path (at an out_size other than its low-res grid) and the
       NNET's normals, checked finite;
    3. ``evaluate_void --stub-frontend`` over the VOID tree (both metric
       tables);
    4. ``run_sfm --odom`` over the TUM tree, read by the native loader, with
       the Sim(3) ATE asserted below 0.05.

Two differences from the real run: the tiny SAM configuration, and the
grid stub frontend in step 4 (random weights cannot segment).
``--full-size`` adds the leg the tiny configuration skips (after step 1):
a ViT-H-sized ``models/sam_vit_h_4b8939_full.pth`` (2.56 GB, the published
names and shapes) through the exact command a user runs on the published
file, ``convert_checkpoints --sam ... --validate`` at the default
``--sam-cfg vit_h``, and then step 2 on the converted ViT-H tree; it
prints the files' sizes, each step's seconds, the host RSS at its start and
its peak and, on a card, the peak device memory, and deletes both 2.56 GB files at the end
unless ``--keep`` is given.  Everything runs on ``--device``, the card by
default.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .convert import load_npz_tree
from .nets.sam.image_encoder import VIT_TINY_TEST
from .nets.synth import synth_nnet_state_dict, synth_sam_state_dict
from .utils.timing import RSSSampler

ATE_LIMIT = 0.05
FULL_PTH, FULL_NPZ = "sam_vit_h_4b8939_full.pth", "sam_vit_h_full.npz"


def build_fixture_tree(root, n_frames: int = 8) -> dict:
    """The synthetic published-format checkpoints and the TUM and VOID
    trees under ``root``."""
    from .data.synthetic import PlanesSequence
    from .eval.dataset_trees import write_tum_tree, write_void_tree

    root = Path(root)
    models = root / "models"
    models.mkdir(parents=True, exist_ok=True)
    sam_pth, nnet_pth = models / "sam_vit_h_4b8939.pth", models / "scannet.pth"
    torch.save({k: torch.from_numpy(v) for k, v in synth_sam_state_dict(VIT_TINY_TEST).items()},
               sam_pth)
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in synth_nnet_state_dict().items()}}, nnet_pth)
    seq = PlanesSequence(n_frames=n_frames, H=64, W=96, step=0.045)
    tum = write_tum_tree(root / "datasets" / "TUM_fr1" / "rgbd_dataset_freiburg1_desk", seq,
                         n_frames)
    void = write_void_tree(root / "datasets" / "void_release", seq, 2, n_sparse=100)
    return {"sam_pth": sam_pth, "nnet_pth": nnet_pth, "tum": tum, "void": void,
            "K": np.asarray(seq.K, np.float64)}


def drive_converted_nets(sam_npz, nnet_npz, device) -> dict:
    """One forward of each converted tree through ``build_frontend``."""
    from .config import load_config
    from .frontend.process_frame import build_frontend

    config = load_config({"frontend": {"normals": {"network_dim": [64, 96],
                                                   "integration_shape": [48, 64]}}})
    fp = build_frontend(config, load_npz_tree(sam_npz), load_npz_tree(nnet_npz), device=device)
    img = np.random.default_rng(0).integers(0, 255, (48, 64, 3), np.uint8)
    predictor = fp.mask_predict_fn.predictor
    predictor.set_image(img)
    masks, iou, stab, area = predictor.predict_points_with_stats(
        np.asarray([[20.0, 10.0], [40.0, 30.0]], np.float32), out_size=32)
    if not all(np.isfinite(np.asarray(a, np.float32)).all() for a in (masks, iou, stab, area)):
        raise AssertionError("the converted SAM gave non-finite outputs")
    print(f"SAM npz -> build_frontend OK: masks {masks.shape}, areas {area.tolist()}")
    normals, kappa = (t.cpu().numpy() for t in fp.normals_fn(img))
    if not (np.isfinite(normals).all() and (kappa > 0).all()):
        raise AssertionError("the converted NNET gave non-finite normals or kappa <= 0")
    print(f"NNET npz -> build_frontend OK: normals {normals.shape}")
    return {"sam_area": area, "normals_shape": normals.shape}


def full_size_leg(models, nnet_npz, device: str = "cuda", sam_cfg: str = "vit_h") -> dict:
    """The ``--full-size`` leg under ``models``: a synthetic SAM ``.pth`` of
    the size of ``convert_checkpoints.SAM_CONFIGS[sam_cfg]`` in the published
    names, ``convert_checkpoints --sam ... --validate --sam-cfg sam_cfg``,
    then step 2 on the converted tree with the NNET tree ``nnet_npz``.
    Returns the files, their bytes, each step's seconds, the embedding's
    std, the host RSS (``utils.timing.RSSSampler``: at the leg's start, the
    leg's peak, and the peak so far at the end of each step) and, on a
    card, the peak device memory since the leg began."""
    from . import convert_checkpoints

    models = Path(models)
    models.mkdir(parents=True, exist_ok=True)
    pth, npz = models / FULL_PTH, models / FULL_NPZ
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rss_by_step = {}
    with RSSSampler() as rss:
        t0 = time.perf_counter()
        cfg = convert_checkpoints.SAM_CONFIGS[sam_cfg]
        torch.save({k: torch.from_numpy(v) for k, v in synth_sam_state_dict(cfg).items()}, pth)
        write_s = time.perf_counter() - t0
        rss_by_step["write"] = rss.peak
        validation = convert_checkpoints.main(
            ["--sam", str(pth), "--out-sam", str(npz), "--validate", "--sam-cfg", sam_cfg,
             "--device", device])
        rss_by_step["convert_validate"] = rss.peak
        if not validation["sam"]["finite"]:
            raise AssertionError(f"the full-size validation found non-finite stages: "
                                 f"{validation}")
        t0 = time.perf_counter()
        nets = drive_converted_nets(npz, nnet_npz, device)
        step2_s = time.perf_counter() - t0
    rss_by_step["step2"] = rss.peak
    out = {"pth": pth, "npz": npz, "pth_bytes": pth.stat().st_size,
           "npz_bytes": npz.stat().st_size, "write_s": write_s,
           "convert_s": validation["seconds"]["sam_convert"],
           "validate_s": validation["seconds"]["sam_validate"], "step2_s": step2_s,
           "embed_std": validation["sam"]["embed_std"], "sam_area": nets["sam_area"],
           "rss_start_bytes": rss.start, "peak_rss_bytes": rss.peak,
           "peak_rss_bytes_by_step": rss_by_step,
           "peak_device_bytes": torch.cuda.max_memory_allocated() if on_card else None}
    gib = {k: f"{v / 2**30:.2f}" for k, v in rss_by_step.items()}
    print(f"full-size leg ({sam_cfg}) on {torch.device(device)}: .pth {out['pth_bytes']:,} B "
          f"(written in {write_s:.1f} s), .npz {out['npz_bytes']:,} B; convert "
          f"{out['convert_s']:.1f} s, validate {out['validate_s']:.1f} s, step 2 "
          f"{step2_s:.1f} s; host RSS {rss.start / 2**30:.2f} GiB at the start, peak "
          f"{rss.peak / 2**30:.2f} GiB (after the write {gib['write']}, convert and validate "
          f"{gib['convert_validate']}, step 2 {gib['step2']})"
          + (f"; peak device memory {out['peak_device_bytes'] / 2**30:.2f} GiB" if on_card
             else ""), flush=True)
    return out


def odometry_config(fx: dict, out_dir: Path) -> dict:
    """The rehearsal's TUM odometry configuration (the root rehearsal's)."""
    K = fx["K"]
    tum = fx["tum"]
    return {
        "save_path": f"{out_dir}/",
        "dataset": {"type": "tum", "path": f"{tum}/", "traj_file": f"{tum}/groundtruth.txt",
                    "intrinsics": [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                                   float(K[1, 2])]},
        "frontend": {"downsample_pow": 0},
        "alignment": {
            "opt_supporting": True,
            "mapping": {"supp_every_n": 2, "init_steps": 40, "steps": 30, "continual_steps": 4,
                        "solver": "gn", "gn_max_iters": 8},
            "mono_init": False, "affine_compensation": False,
            "pyramid_min": 0, "pyramid_max": 1,
            "track": {"lr": 0.005, "pyramid_min": 0, "pyramid_max": 2, "steps": [0, 40],
                      "solver": "gn", "gn_max_iters": 10},
            "init_frames": 3,
        },
        "kf": {"depth_validity_ratio": 0.70, "translation_thresh": 0.02},
        "window_size": 4,
    }


def rehearse(root, n_frames: int = 8, device: str = "cuda", full_size: bool = False) -> dict:
    """The four steps under ``root`` (and the full-size leg after step 1
    with ``full_size``); returns their results."""
    import yaml

    from . import convert_checkpoints, evaluate_void, run_sfm

    root = Path(root)
    fx = build_fixture_tree(root, n_frames)
    sam_npz, nnet_npz = root / "models" / "sam_vit_h.npz", root / "models" / "nnet_scannet.npz"

    print("1. convert_checkpoints --validate", flush=True)
    validation = convert_checkpoints.main([
        "--sam", str(fx["sam_pth"]), "--out-sam", str(sam_npz),
        "--nnet", str(fx["nnet_pth"]), "--out-nnet", str(nnet_npz),
        "--validate", "--sam-cfg", "tiny", "--device", device])
    if not (validation["sam"]["finite"] and validation["nnet"]["finite"]):
        raise AssertionError(f"validation found non-finite stages: {validation}")
    full = None
    if full_size:
        print("1b. the full-size leg: a ViT-H .pth -> convert_checkpoints --validate -> step 2",
              flush=True)
        full = full_size_leg(root / "models", nnet_npz, device)

    print("2. the converted trees through build_frontend", flush=True)
    nets = drive_converted_nets(sam_npz, nnet_npz, device)

    print("3. evaluate_void --stub-frontend", flush=True)
    void = evaluate_void.main(["--dataset", str(fx["void"]), "--stub-frontend",
                               "--max-images", "2", "--device", device])
    if set(void["tables"]) != {"filled", "valid-only"}:
        raise AssertionError(f"evaluate_void tables: {sorted(void['tables'])}")

    print("4. run_sfm --odom over the TUM tree", flush=True)
    cfg_path = root / "odom_desk_rehearsal.yaml"
    cfg_path.write_text(yaml.safe_dump(odometry_config(fx, root / "results" / "desk")))
    odom = run_sfm.main(["--config", str(cfg_path), "--odom", "--stub-frontend",
                         "--stub-rows", "4", "--stub-cols", "5", "--max-frames", str(n_frames),
                         "--device", device])
    loader = odom["odom"].dataset._rgb_loader
    if loader is None:
        raise AssertionError("run_sfm read the TUM tree without the native loader")
    ate = odom["ate"]
    if ate is None or not ate["rmse"] < ATE_LIMIT:
        raise AssertionError(f"rehearsal ATE {ate} is not below {ATE_LIMIT}")
    print(f"day0_rehearsal OK: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} keyframes "
          f"(root: {root})")
    return {"validation": validation, "full_size": full, "nets": nets, "void": void, "ate": ate}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None, help="fixture root (default: a temporary one)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the temporary fixture root and the full-size files")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-size", action="store_true",
                    help="also take a ViT-H-sized .pth (2.56 GB) through convert_checkpoints "
                         "--validate and step 2")
    args = ap.parse_args(argv)
    root = args.dir or tempfile.mkdtemp(prefix="day0_rehearsal_")
    try:
        return rehearse(root, args.frames, args.device, full_size=args.full_size)
    finally:
        if args.dir is None and not args.keep:
            shutil.rmtree(root, ignore_errors=True)
        elif args.full_size and not args.keep:
            for name in (FULL_PTH, FULL_NPZ):
                (Path(root) / "models" / name).unlink(missing_ok=True)


if __name__ == "__main__":
    main()
