"""Frame-to-keyframe tracking with retraction Adam.

Port of ``super_primitive_tpu/odometry/tracker.py`` (``track_level`` and
``track_frame``; the JAX package's ``track_frame_fused`` is the same
computation in one jit and has no separate counterpart here).  Per frame:
optimise an SE(3) delta (and optionally the frame's affine brightness)
aligning the latest keyframe's points with the new frame's image, coarse to
fine over an image pyramid with per-level step counts.

- The cost pose is ``exp(delta) @ R`` with R = inv(T_frame) @ T_kf; after
  each step the delta folds into R and restarts at zero, its Adam moments
  persisting across steps and levels;
- source samples are computed once per level;
- learning rates: the pose's from the config, the affine's 5e-3;
- fixed step counts (the reference's convergence flag is never set);
- T_frame = renormalize(T_kf @ inv(R)) at the end.
"""

from __future__ import annotations

import torch

from ..cost import photometric as ph
from ..image import pyramid as pyr
from ..keyframe import PointBundle
from ..lie import se3
from ..ops.sampling import pack_bilinear_taps
from ..solve.retraction_adam import ScaleByAdam


def make_track_optimizer(affine: torch.Tensor) -> ScaleByAdam:
    """Adam moments for the pose tangent (6,) and the affine (2,)."""
    return ScaleByAdam([torch.zeros(6, device=affine.device), affine])


def track_level(bundle: PointBundle, src_samples: ph.SourceSamples,
                trg_image: torch.Tensor, K: torch.Tensor, kp_logdepth: torch.Tensor,
                kp_base: torch.Tensor, R: torch.Tensor, affine: torch.Tensor,
                kf_affine: torch.Tensor, opt: ScaleByAdam, lr_pose: float,
                lr_affine: float, geo_dims: tuple[int, int], num_steps: int,
                use_affine: bool):
    """``num_steps`` tracking iterations at one pyramid level.  Returns
    (R, affine, losses (num_steps,) on the device)."""
    trg_packed = pack_bilinear_taps(trg_image)
    kp_logdepth, kp_base = kp_logdepth.detach(), kp_base.detach()
    losses = torch.empty(num_steps, device=R.device)
    R, affine = R.detach(), affine.detach()
    for i in range(num_steps):
        xi = torch.zeros(6, device=R.device, requires_grad=True)
        aff = affine.clone().requires_grad_(True)
        pose = se3.exp(xi) @ R
        loss = ph.photometric_cost(
            bundle, src_samples, trg_packed, K, geo_dims, kp_logdepth, kp_base, pose,
            affine=(kf_affine, aff) if use_affine else None,
        )
        g_xi, g_aff = torch.autograd.grad(loss, [xi, aff], allow_unused=True)
        if g_aff is None:
            g_aff = torch.zeros_like(affine)
        d_xi, d_aff = opt.direction([g_xi, g_aff])
        with torch.no_grad():
            R = se3.exp(-lr_pose * d_xi) @ R
            if use_affine:
                affine = affine - lr_affine * d_aff
        losses[i] = loss.detach()
    return R, affine, losses


def track_frame(bundle: PointBundle, kf_image_pyr: list[torch.Tensor],
                trg_image: torch.Tensor, K: torch.Tensor, kp_logdepth: torch.Tensor,
                kp_base: torch.Tensor, T_kf: torch.Tensor, T_init: torch.Tensor,
                kf_affine: torch.Tensor, affine_init: torch.Tensor,
                geo_dims: tuple[int, int], steps: tuple[int, ...], lr_pose: float,
                pyramid_min: int, pyramid_max: int, lr_affine: float = 5e-3,
                use_affine: bool = False):
    """Coarse-to-fine tracking of one frame against the latest keyframe.

    ``kf_image_pyr`` is coarsest-first and matches ``steps``; the target
    pyramid is built here from ``trg_image``.  Returns (T_frame (4, 4)
    world pose, affine (2,), per-level losses)."""
    trg_pyr = pyr.image_pyramid(trg_image, pyramid_min, pyramid_max)
    R = se3.inverse(T_init) @ T_kf
    affine = affine_init
    opt = None
    all_losses = []
    for level, n in enumerate(steps):
        if n <= 0:
            continue
        src = ph.precompute_source(kf_image_pyr[level], bundle, geo_dims)
        if opt is None:
            opt = make_track_optimizer(affine)
        R, affine, losses = track_level(
            bundle, src, trg_pyr[level], K, kp_logdepth, kp_base, R, affine,
            kf_affine, opt, lr_pose, lr_affine, geo_dims, int(n), bool(use_affine),
        )
        all_losses.append(losses)
    T_frame = se3.renormalize(T_kf @ se3.inverse(R))
    return T_frame, affine, all_losses
