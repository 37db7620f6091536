"""The multi-device dry run and the sharded flows it drives.

    python -m super_primitive_tpu_torch.parallel.dryrun --n N [--device cpu] [--backend gloo]

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``: on
an n-rank (dp, sp) mesh it runs, on seeded synthetic data, the sharded
Adam mapping step, a GN mapping solve, the fused frame step, the SAM
encode (tiny ViT), BiNI and the CC labeller, and rank 0 prints one line
with the mesh and a number from each.  It runs on the card unless the
caller asks for the CPU; the backend defaults to the device's production
one (``nccl`` on CUDA, ``gloo`` on the CPU), and ``nccl`` needs a card per
rank.

Each flow is a function ``flow_*(mesh, ..., device=...)`` that takes host
data, moves it to the rank's device, places it on the mesh and runs the
port's own entry point on it; with ``mesh=None`` the same function runs
unsharded on ``device``, which is the reference the sharded run is held
to.  Every flow's output says whether all ranks hold it bit for bit (and,
for the LM solves, ran the same iterations).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..integrate.bini import BiniConfig, integrate_normals, integrate_normals_cropped
from ..keyframe import build_bundle_np
from ..lie import se3
from ..nets.sam.predictor import SamPredictor
from ..odometry import mapper, window
from ..odometry.fused_step import fused_frame_step
from ..ops import phase_counts as k3
from ..ops.connected_components import label_components
from ..solve import gn_mapping as gm
from . import launch
from .mesh import Mesh, gather_rows, same_on_all_ranks, shard_rows, shard_window


def _device(mesh: Mesh | None, device) -> torch.device:
    return mesh.device if mesh is not None else torch.device(device)


def window_to(buffers: window.WindowBuffers, device) -> window.WindowBuffers:
    """A copy of unsharded window buffers on ``device``."""
    return window.WindowBuffers(**{
        f.name: (getattr(buffers, f.name).to(device, copy=True)
                 if torch.is_tensor(getattr(buffers, f.name)) else getattr(buffers, f.name).copy())
        for f in dataclasses.fields(window.WindowBuffers)})


def _placed(buffers, mesh, device):
    b = window_to(buffers, _device(mesh, device))
    return b if mesh is None else shard_window(b, mesh)


def _replicated(mesh, tensors) -> bool:
    return True if mesh is None else same_on_all_ranks(tensors, mesh.world)


def _par_mask(masks, device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([np.repeat(masks.xi_mask, 6),
                                           np.repeat(masks.affine_mask, 2)]), device=device)


# -------------------------------------------------------------------- flows

def flow_adam(mesh, buffers, slots, masks, geo_dims, max_iters: int, device="cuda") -> dict:
    """``mapper.run_mapping`` (retraction Adam, the scheduled map's rates,
    no early stop) with targets over dp and points over sp."""
    b = _placed(buffers, mesh, device)
    r = mapper.run_mapping(b, slots, masks, 1e-4, 1e-2, 1e-5, max_iters, False, False, geo_dims)
    losses = torch.tensor(r.losses, dtype=torch.float64)
    return {"poses": r.poses, "kp_logdepth": r.kp_logdepth, "affine": r.affine,
            "losses": losses, "num_iters": r.num_iters,
            "replicated": _replicated(mesh, (r.poses, r.kp_logdepth, r.affine))}


def flow_assemble(mesh, buffers, slots, masks, geo_dims, use_affine: bool = False,
                  point_stride: int = 1, device="cuda") -> dict:
    """One ``gn_mapping.assemble`` of the window's problem, points over sp."""
    b = _placed(buffers, mesh, device)
    lin = gm.assemble(b, slots.trg_index, slots.trg_valid, slots.src_valid,
                      _par_mask(masks, b.images.device), geo_dims, use_affine, b.pose_pool(),
                      b.kp_logdepth, b.affine_pool(), point_stride)
    return {"lin": lin, "replicated": _replicated(mesh, lin)}


def flow_gn_mapping(mesh, buffers, slots, masks, geo_dims, device="cuda", **kw) -> dict:
    """A ``gn_mapping`` solve, points over sp; ``kw`` are its options."""
    b = _placed(buffers, mesh, device)
    r = gm.gn_mapping(b, slots.trg_index, slots.trg_valid, slots.src_valid, masks.xi_mask,
                      masks.ld_mask, masks.affine_mask, geo_dims, **kw)
    iters = torch.tensor([r.num_iters], device=r.poses.device)
    out = (r.poses, r.kp_logdepth, r.affine, r.initial_cost, r.final_cost, iters)
    return {"poses": r.poses, "kp_logdepth": r.kp_logdepth, "affine": r.affine,
            "initial_cost": r.initial_cost, "final_cost": r.final_cost,
            "num_iters": r.num_iters, "replicated": _replicated(mesh, out)}


def flow_fused(mesh, buffers, step: dict, device="cuda") -> dict:
    """``fused_frame_step`` on the window, points over sp.  ``step`` holds
    its other arguments (host data; tensors move to the device)."""
    b = _placed(buffers, mesh, device)
    dev = b.images.device
    kw = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in step.items()}
    r = fused_frame_step(b, **kw)
    packed = torch.from_numpy(r.packed)
    iters = torch.tensor(r.track_iters + [r.supp_iters], device=dev)
    return {"packed": packed, "kp_logdepth": r.kp_logdepth, "track_iters": r.track_iters,
            "supp_iters": r.supp_iters,
            "replicated": _replicated(mesh, (packed.to(dev), r.kp_logdepth, iters))}


def flow_encode(mesh, state_dict, cfg, images, device="cuda") -> dict:
    """``SamPredictor.encode_batch`` (float32) with the image batch over dp."""
    dev = _device(mesh, device)
    pred = SamPredictor(state_dict, cfg, device=dev)
    feats = pred.encode_batch(images.to(dev), group=None if mesh is None else mesh.dp)
    return {"features": feats, "replicated": _replicated(mesh, (feats,))}


def flow_decode(mesh, state_dict, cfg, features, input_hw, pts, out_size: int,
                compute_dtype=None, counts: bool = True, device="cuda") -> dict:
    """``SamPredictor._decode_select`` on ``features`` with the prompts over
    every rank, the IoU and stability filters off (every candidate is
    good, the smallest by K3's area is picked); with ``counts``, K3's (hi,
    lo, area) of each rank's prompts, gathered in prompt order."""
    dev = _device(mesh, device)
    group = None if mesh is None else mesh.world
    pred = SamPredictor(state_dict, cfg, compute_dtype, device=dev, encoder=False)
    pred.set_features(features, input_hw)
    pts = pts.to(dev)
    sel = pred._decode_select(pts, tuple(input_hw), out_size, 0.0, 0.0, group=group)
    out = dict(zip(("packed", "iou", "valid", "boxes", "pick"), sel))
    if counts:
        local, part = shard_rows(pts, group)
        lowres = pred._decode(local)[0][:, 1:]
        S = lowres.shape[-1]
        hlc = k3.phase_counts(lowres.reshape(-1, S, S).contiguous(), pred.target_length // S,
                              tuple(input_hw))
        out["counts"] = gather_rows(torch.stack(hlc, dim=-1).reshape(local.shape[0], -1, 3),
                                    part)
    out["replicated"] = _replicated(mesh, tuple(v for v in out.values() if torch.is_tensor(v)))
    return out


def flow_bini(mesh, normals, masks, K, config: BiniConfig, crop: int | None = None,
              return_crops: bool = False, device="cuda") -> dict:
    """BiNI with the segments over sp (``integrate_normals_cropped`` when
    ``crop`` is set)."""
    dev = _device(mesh, device)
    group = None if mesh is None else mesh.sp
    args = (normals.to(dev), masks.to(dev), K.to(dev), config)
    if crop is None:
        out = (integrate_normals(*args, group=group),)
    else:
        out = integrate_normals_cropped(*args, crop, return_crops=return_crops, group=group)
        out = out if return_crops else (out,)
    return {"out": tuple(out), "replicated": _replicated(mesh, tuple(out))}


def flow_cc(mesh, masks, device="cuda") -> dict:
    """The CC labeller with the masks over sp."""
    dev = _device(mesh, device)
    labels = label_components(masks.to(dev), group=None if mesh is None else mesh.sp)
    return {"labels": labels, "replicated": _replicated(mesh, (labels,))}


FLOWS = {"adam": flow_adam, "assemble": flow_assemble, "gn_mapping": flow_gn_mapping,
         "fused": flow_fused, "encode": flow_encode, "decode": flow_decode,
         "bini": flow_bini, "cc": flow_cc}


def run_flows(mesh, jobs, device="cuda") -> list:
    """Run ``jobs``, a list of (flow name, keyword arguments), in order; each
    output carries its wall ``seconds`` (the device synchronised)."""
    outs = []
    for name, kw in jobs:
        dev = _device(mesh, device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = FLOWS[name](mesh, device=dev, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"] = time.perf_counter() - t0
        outs.append(out)
    return outs


# ------------------------------------------------------------ synthetic data

def tiny_window(supp_capacity: int = 1):
    """A 3-keyframe window (4 segments, 32x48) on the host, and its geometry
    dims: the JAX dry run's ``_tiny_window``."""
    H, Wd, n_seg, cap = 32, 48, 4, 2048
    r = np.random.default_rng(1)
    K = np.array([[1.2 * Wd, 0, Wd / 2], [0, 1.2 * Wd, H / 2], [0, 0, 1.0]], np.float32)
    regions = np.zeros((n_seg, H, Wd), bool)
    for i, (r0, c0) in enumerate([(2, 2), (2, Wd // 2), (H // 2, 2), (H // 2, Wd // 2)]):
        regions[i, r0:r0 + H // 2 - 3, c0:c0 + Wd // 2 - 3] = True
    kp_rc = np.asarray([[6, 6], [6, Wd // 2 + 4], [H // 2 + 4, 6], [H // 2 + 4, Wd // 2 + 4]])
    buf = window.empty_window(3, supp_capacity, (H, Wd), 3, n_seg, cap, device="cpu")
    for slot in range(3):
        logdepth = (r.uniform(0.4, 0.7, (n_seg, 1, 1)) * regions).astype(np.float32)
        bundle = build_bundle_np(regions, logdepth, capacity=cap, device="cpu")
        kp_base = logdepth[np.arange(n_seg), kp_rc[:, 0], kp_rc[:, 1]]
        pose = se3.exp(torch.from_numpy(0.02 * r.normal(size=6).astype(np.float32))).numpy()
        img = r.uniform(0, 1, (H, Wd, 3)).astype(np.float32)
        window.set_keyframe_slot(buf, slot, img, K, pose, kp_base, np.zeros(2, np.float32),
                                 bundle, kp_base)
    return buf, (H, Wd)


def bini_case(n_segments: int, seed: int = 5):
    """(normals (24, 32, 3), masks (N, 24, 32), K) of the JAX sharded-BiNI
    dry run and test."""
    H, Wd = 24, 32
    r = np.random.default_rng(seed)
    K = torch.tensor([[1.2 * Wd, 0, Wd / 2], [0, 1.2 * Wd, H / 2], [0, 0, 1.0]])
    n = r.normal(size=(H, Wd, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2]) - 1.0
    normals = torch.from_numpy(n / np.linalg.norm(n, axis=-1, keepdims=True))
    masks = np.zeros((n_segments, H, Wd), bool)
    for i in range(n_segments):
        r0, c0 = 2 + (i % 3) * 4, 2 + (i % 4) * 6
        masks[i, r0:r0 + 8, c0:c0 + 8] = True
    return normals, torch.from_numpy(masks), K


def dryrun_jobs(mesh: Mesh) -> list:
    """The dry run's six flows at the JAX dry run's sizes for ``mesh``."""
    from ..nets import synth
    from ..nets.sam.image_encoder import VIT_TINY_TEST

    buf, geo = tiny_window()
    supp_valid = buf.supp_valid.numpy()
    slots = mapper.build_slots(3, 3, supp_valid, "map")
    masks = mapper.build_masks(3, 3, supp_valid, "map", 3, False, False)

    fbuf, _ = tiny_window(supp_capacity=2)
    fvalid = np.zeros((3, 2), bool)
    fvalid[2, 0] = True
    fslots = mapper.build_slots(3, 3, fvalid, "supp")
    step = dict(kf_slot=2, trg_image=fbuf.images[2].clone(), T_init=fbuf.poses[2].clone(),
                current_aff=torch.zeros(2), prev_img=None, prev_pose=None, prev_aff=None,
                supp_trg_index=fslots.trg_index[2], supp_trg_valid=fslots.trg_valid[2],
                geo_dims=geo, levels=(0, 1), pyramid_min=0, pyramid_max=2, max_iters=3,
                supp_max_iters=2)

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    cfg = VIT_TINY_TEST
    r = np.random.default_rng(3)
    images = torch.from_numpy(r.uniform(0, 1, (2 * dp, cfg.img_size, cfg.img_size, 3))
                              .astype(np.float32))
    normals, bmasks, K = bini_case(2 * sp)
    cc_masks = torch.from_numpy(np.random.default_rng(9).uniform(size=(2 * sp, 24, 32)) < 0.4)
    return [
        ("adam", dict(buffers=buf, slots=slots, masks=masks, geo_dims=geo, max_iters=1)),
        ("gn_mapping", dict(buffers=buf, slots=slots, masks=masks, geo_dims=geo,
                            max_iters=2, tol=0.0)),
        ("fused", dict(buffers=fbuf, step=step)),
        ("encode", dict(state_dict=synth.synth_sam_state_dict(cfg), cfg=cfg, images=images)),
        ("bini", dict(normals=normals, masks=bmasks, K=K,
                      config=BiniConfig(cg_max_iter=40, cg_tol=1e-4))),
        ("cc", dict(masks=cc_masks)),
    ]


def _dryrun_rank(mesh: Mesh) -> dict:
    adam, gn, fused, enc, bini, cc = run_flows(mesh, dryrun_jobs(mesh))
    summary = {
        "mesh": mesh.shape,
        "adam_loss": float(adam["losses"][-1]),
        "gn_cost": float(gn["final_cost"]),
        "fused_track_cost": float(fused["packed"][21]),
        "encode_abs_sum": float(enc["features"].abs().sum()),
        "bini_abs_sum": float(bini["out"][0].abs().sum()),
        "cc_max_label": int(cc["labels"].max()),
        "replicated": all(o["replicated"] for o in (adam, gn, fused, enc, bini, cc)),
    }
    finite = [summary[k] for k in ("adam_loss", "gn_cost", "fused_track_cost")]
    if not (all(np.isfinite(finite)) and summary["encode_abs_sum"] > 0
            and summary["bini_abs_sum"] > 0 and summary["cc_max_label"] > 0
            and summary["replicated"]):
        raise RuntimeError(f"dry run failed its checks: {summary}")
    if mesh.world.rank == 0:
        print(f"dryrun_multichip OK: mesh {summary['mesh']} on {mesh.device} | adam loss "
              f"{summary['adam_loss']:.6f} | sharded gn_mapping cost {summary['gn_cost']:.6f} | "
              f"sharded fused_step track cost {summary['fused_track_cost']:.6f} | "
              f"sharded sam_encode |sum| {summary['encode_abs_sum']:.6f} | "
              f"sharded bini |zt| {summary['bini_abs_sum']:.6f} | "
              f"sharded cc max label {summary['cc_max_label']}", flush=True)
    return summary


def dryrun_multichip(n: int, device: str = "cuda", backend: str | None = None) -> list:
    """The six sharded flows on ``n`` ranks; each rank's summary.
    ``backend`` None is ``nccl`` on CUDA and ``gloo`` on the CPU."""
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    return launch.run(_dryrun_rank, n, backend, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, required=True, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=launch.BACKENDS,
                    help="default: nccl on cuda, gloo on cpu")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, a.device, a.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
