"""Two-frame SfM solve: joint per-segment log-depths and supporting poses.

Port of ``super_primitive_tpu/solve/two_frame.py`` (``solve_two_frame``,
``solve_two_frame_gn`` and ``random_depth_seeds``).  Per pyramid level,
coarse to fine, ``num_iters`` retraction-Adam steps minimise the summed
photometric costs of the supporting frames.  The Adam state carries across
levels (the reference builds its optimizer once), and the very first
iteration is viz-only.  With ``snapshot_cb`` a level runs in chunks
between which the callback sees the parameters (the live viewer of
``run_sfm --live-viz``); the solve is the same as unchunked.  The GN
variant poses the same problem as the Schur-complement system of
``solve/gn_mapping.py`` on a one-keyframe window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..cost import photometric as ph
from ..keyframe import KeyFramePyramid
from ..lie import se3
from ..odometry import window as win
from ..ops.sampling import pack_bilinear_taps
from ..utils.timing import to_host
from .gn_mapping import gn_mapping
from .retraction_adam import OptParams, current_poses, make_optimizer, run_adam


@dataclasses.dataclass(frozen=True)
class TwoFrameConfig:
    num_iters: int = 500           # per level
    lr_depth: float = 1e-3
    lr_pose: float = 1e-2
    depth_seed_low: float = 2.0    # seeds 2 + 2*rand
    depth_seed_high: float = 4.0
    pose_noise_sigma: float = 0.05


def random_depth_seeds(
    generator: torch.Generator, num_segments: int, cfg: TwoFrameConfig,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Log of uniform [low, high) depth seeds, drawn on the host from the
    CPU ``generator``."""
    u = torch.rand(num_segments, generator=generator)
    d = cfg.depth_seed_low + (cfg.depth_seed_high - cfg.depth_seed_low) * u
    return torch.log(d).to(device)


def solve_two_frame(
    src_pyr: KeyFramePyramid,
    supp_pyrs: Sequence[KeyFramePyramid],
    init_poses: torch.Tensor,
    init_kp_logdepth: torch.Tensor,
    cfg: TwoFrameConfig = TwoFrameConfig(),
    snapshot_cb=None,
    snapshot_every: int = 0,
):
    """Coarse-to-fine joint pose + depth optimisation.

    ``init_poses`` is (B, 4, 4) T_support_from_src for each supporting frame.
    Returns (poses (B, 4, 4), kp_logdepth (N,), losses: one (num_iters,)
    tensor per level).

    ``snapshot_cb(level, iters_done, params, chunk_losses)``, with
    ``snapshot_every`` k > 0, runs each level as ceil(num_iters / k) chunks
    and is called after each; the parameters and the Adam state carry
    across chunks, so the solve equals the unchunked one."""
    bundle = src_pyr.bundle
    geo = src_pyr.geo
    if bundle is None or geo is None:
        raise ValueError("the source pyramid needs segment geometry and a bundle")
    kp_base = geo.keypoint_base_logdepth()
    geo_dims = geo.geo_dims
    K = src_pyr.K
    B = init_poses.shape[0]
    device = init_poses.device

    params = OptParams(
        poses=init_poses.detach().clone(),
        xi=torch.zeros((B, 6), device=device),
        kp_logdepth=init_kp_logdepth.detach().clone(),
    )
    optimizer = make_optimizer(params, cfg.lr_depth, cfg.lr_pose)

    snapshots = bool(snapshot_cb is not None and snapshot_every)
    chunk = snapshot_every if snapshots else cfg.num_iters
    all_losses = []
    for level in range(src_pyr.num_levels):
        src_samples = ph.precompute_source(src_pyr.images[level], bundle, geo_dims)
        trg_packed = [pack_bilinear_taps(p.images[level]) for p in supp_pyrs]

        def loss_fn(poses, kp_logdepth):
            # reference: loss = sum_b |mean residual_b|
            total = 0.0
            for b in range(B):
                total = total + torch.abs(ph.photometric_cost(
                    bundle, src_samples, trg_packed[b], K, geo_dims,
                    kp_logdepth, kp_base, poses[b],
                ))
            return total

        done, level_losses = 0, [torch.zeros(0, device=device)]
        while done < cfg.num_iters:
            k = min(chunk, cfg.num_iters - done)
            losses = run_adam(loss_fn, params, optimizer, k,
                              skip_first_step=level == 0 and done == 0)
            done += k
            level_losses.append(losses)
            if snapshots:
                snapshot_cb(level, done, params, losses)
        all_losses.append(torch.cat(level_losses))

    with torch.no_grad():
        poses = current_poses(params)
    return poses, params.kp_logdepth.detach(), all_losses


def solve_two_frame_gn(
    src_pyr: KeyFramePyramid,
    supp_pyrs: Sequence[KeyFramePyramid],
    init_poses: torch.Tensor,
    init_kp_logdepth: torch.Tensor,
    max_iters: int = 25,
    levels: Optional[Sequence[int]] = None,
):
    """GN/LM two-frame SfM: the problem of :func:`solve_two_frame` as the
    scalar-landmark Schur system of ``solve/gn_mapping`` with one source
    keyframe.  The source pose is the gauge (frozen), the supporting poses
    are free cameras, the per-segment log-depths the diagonal landmark
    block.  Coarse to fine over ``levels`` (default every level) with
    ``max_iters`` LM iterations each.

    Returns (poses (B, 4, 4) T_support_from_src, kp_logdepth (N,), losses:
    per level (initial, final) cost)."""
    bundle, geo = src_pyr.bundle, src_pyr.geo
    if bundle is None or geo is None:
        raise ValueError("the source pyramid needs segment geometry and a bundle")
    geo_dims = geo.geo_dims
    B = init_poses.shape[0]
    kp_base = to_host(geo.keypoint_base_logdepth())
    N = kp_base.shape[0]
    K = to_host(src_pyr.K)
    levels = list(range(src_pyr.num_levels)) if levels is None else list(levels)
    kp_ld = init_kp_logdepth
    # world frame = the source camera: a support's T_wc = inv(T_support_from_src)
    supp_T = se3.inverse(init_poses)

    trg_index = np.arange(1, B + 1)[None, :]          # image-pool indices
    trg_valid = np.ones((1, B), bool)
    src_valid = np.ones((1,), bool)
    xi_mask = np.concatenate([np.zeros(1), np.ones(B)]).astype(np.float32)
    ld_mask = np.ones(1, np.float32)
    affine_mask = np.zeros(1 + B, np.float32)

    losses = []
    for lv in levels:
        img = src_pyr.images[lv]
        buf = win.empty_window(1, B, tuple(img.shape[:2]), img.shape[-1], N, bundle.capacity,
                               device=img.device)
        win.set_keyframe_slot(buf, 0, to_host(img), K, np.eye(4, dtype=np.float32),
                              to_host(kp_ld), np.zeros(2, np.float32), bundle, kp_base)
        for j in range(B):
            win.set_supporting_slot(buf, 0, j, supp_pyrs[j].images[lv], to_host(supp_T[j]),
                                    np.zeros(2, np.float32))
        res = gn_mapping(buf, trg_index, trg_valid, src_valid, xi_mask, ld_mask, affine_mask,
                         geo_dims, max_iters=max_iters, use_affine=False)
        kp_ld = res.kp_logdepth[0]
        supp_T = res.poses[1:]
        losses.append(tuple(float(c) for c in to_host(
            torch.stack([res.initial_cost, res.final_cost]))))
    return se3.inverse(supp_T), kp_ld, losses
