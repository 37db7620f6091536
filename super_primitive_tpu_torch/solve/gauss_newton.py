"""Gauss-Newton / Levenberg-Marquardt tracking, the performance path.

Port of ``super_primitive_tpu/solve/gauss_newton.py``: 8 parameters (6 pose
tangent + 2 affine) against the dense photometric residual.  The (P, C, 8)
Jacobian comes from ``torch.func.jacfwd`` of the plain residual (the JAX
package's ``jax.jacfwd``); JtJ and Jtr are 8x8 reductions summed in float64
and rounded to float32 once (``utils.numerics.einsum64``); the damped
system is solved in float32 with
``torch.linalg.solve_ex``, which, like JAX, returns non-finite values on a
singular matrix instead of raising, so the solve never waits for the host.

Robustness: IRLS weights w = 1/max(|r|, 1e-3) match the reference's L1
objective; ``huber`` and ``none`` (pure L2) are the alternatives.

The LM loop is a Python loop that reads the stop flag on the host once per
iteration (``utils.timing.host_flag``) and breaks on it, so its iteration
counts are those of the JAX package's ``lax.while_loop``; it makes no other
host read.

On a bundle sharded over sp (``parallel.mesh.shard_bundle``) JtJ, Jtr and
the costs' sums are reduced over its group before the host reads the
flag: one ``reduce_sum`` per linearization and one per trial cost.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd

from ..cost import photometric as ph
from ..geometry import projection
from ..keyframe import PointBundle
from ..lie import se3
from ..ops.sampling import bilinear_sample_packed, pack_bilinear_taps
from ..parallel.mesh import reduce_sum
from ..utils.numerics import einsum64
from ..utils.timing import host_flag

N_PAR = 8


class GNResult(NamedTuple):
    R: torch.Tensor             # (4, 4) refined relative pose
    affine: torch.Tensor        # (2,)
    num_iters: int
    final_cost: torch.Tensor    # () on the device
    initial_cost: torch.Tensor


def _residuals(params: torch.Tensor, R: torch.Tensor, bundle: PointBundle,
               src: ph.SourceSamples, trg_packed: torch.Tensor, K: torch.Tensor,
               geo_dims: tuple[int, int], kp_logdepth: torch.Tensor,
               kp_base: torch.Tensor, kf_affine: torch.Tensor, use_affine: bool):
    """Per-point residuals (P, C) and validity (P,) at the tangent
    ``params`` = (xi[6], affine[2]) around the relative pose R, on a
    :func:`pack_bilinear_taps` target image (the residual is masked by
    ``valid``, so the packing contract holds)."""
    pose = se3.exp(params[:6]) @ R
    logd = ph.spread_logdepth(bundle, kp_logdepth, kp_base)
    pts = projection.unproject(bundle.uv, torch.exp(logd), K)
    pts_t = projection.transform(pts, pose)
    coords = ph.normalized_image_coords(projection.project(pts_t, K), geo_dims)
    trg_pixels, trg_valid = bilinear_sample_packed(trg_packed, coords)
    trg_valid = trg_valid & (pts_t[..., 2] > ph.Z_VALID_SINGLE)
    if use_affine:
        trg_pixels = ph.affine_compensate(trg_pixels, kf_affine, params[6:8])
    valid = (src.valid & trg_valid).to(trg_pixels.dtype)
    # colour mode: the RGB channels only
    r = (src.pixels[..., :3] - trg_pixels[..., :3]) * valid[..., None]
    return r, valid


def _weights(r: torch.Tensor, robust: str, huber_delta: float) -> torch.Tensor:
    a = torch.abs(r)
    if robust == "l1":
        return 1.0 / torch.clamp(a, min=1e-3)
    if robust == "huber":
        return torch.clamp(huber_delta / torch.clamp(a, min=1e-12), max=1.0)
    if robust == "none":
        return torch.ones_like(r)
    raise ValueError(f"unknown robust weight {robust!r}")


def gn_track(bundle: PointBundle, src: ph.SourceSamples, trg_image: torch.Tensor,
             K: torch.Tensor, kp_logdepth: torch.Tensor, kp_base: torch.Tensor,
             R0: torch.Tensor, affine0: torch.Tensor, kf_affine: torch.Tensor,
             geo_dims: tuple[int, int], max_iters: int = 20, use_affine: bool = False,
             robust: str = "l1", huber_delta: float = 0.1, tol: float = 1e-6) -> GNResult:
    """LM refinement of the tracking relative pose (and affine)."""
    dev = R0.device
    eps = 1e-6
    trg_packed = pack_bilinear_taps(trg_image)
    num_valid = max(bundle.num_valid, 1)
    zeros6 = torch.zeros(6, device=dev)
    eye = torch.eye(N_PAR, device=dev)
    aff_on = 1.0 if use_affine else 0.0

    def residuals(p, R):
        return _residuals(p, R, bundle, src, trg_packed, K, geo_dims, kp_logdepth, kp_base,
                          kf_affine, use_affine)

    def cost_of(r, total=None):
        # the reference objective: L1 mean over channels x region points;
        # ``total``: the sum |r| over the group, when already reduced
        if total is None:
            total = reduce_sum(torch.sum(torch.abs(r)), bundle.group)
        return total / (r.shape[-1] * num_valid)

    def linearize(R, affine):
        p0 = torch.cat([zeros6, affine])

        def res_aux(p):
            r, valid = residuals(p, R)
            return r, (r, valid)

        J, (r0, valid) = jacfwd(res_aux, has_aux=True)(p0)     # (P, C, 8)
        w = _weights(r0, robust, huber_delta) * valid[..., None]
        Jw = J * w[..., None]
        # JtJ and Jtr in float64 (einsum64), the cost's float32 sum carried
        # exactly beside them: one collective, each rounded once after it
        sums = reduce_sum((einsum64("pci,pcj->ij", Jw, J), einsum64("pci,pc->i", Jw, r0),
                           torch.sum(torch.abs(r0)).to(torch.float64)), bundle.group)
        return r0, *(x.to(r0.dtype) for x in sums)

    R, affine = R0, affine0
    cost_init = cost_of(residuals(torch.cat([zeros6, affine0]), R0)[0])
    cost = cost_init
    lam = torch.tensor(1e-3, device=dev)
    it = 0
    while it < max_iters:
        r0, JtJ, Jtr, abs0 = linearize(R, affine)
        cost0 = cost_of(r0, abs0)
        damped = JtJ + lam * torch.diag(torch.diag(JtJ)) + eps * eye
        step = -torch.linalg.solve_ex(damped, Jtr[:, None])[0][:, 0]
        R_new = se3.renormalize(se3.exp(step[:6]) @ R)
        affine_new = affine + step[6:8] * aff_on
        cost1 = cost_of(residuals(torch.cat([zeros6, affine_new]), R_new)[0])

        improved = cost1 < cost0
        R = torch.where(improved, R_new, R)
        affine = torch.where(improved, affine_new, affine)
        lam = torch.where(improved, torch.clamp(lam * 0.33, min=1e-7), lam * 4.0)
        rel = torch.abs(cost0 - cost1) / torch.clamp(cost0, min=1e-30)
        done = (improved & (rel < tol)) | (lam > 1e4)
        cost = torch.where(improved, cost1, cost0)
        it += 1
        if host_flag(done):
            break
    return GNResult(R=R, affine=affine, num_iters=it, final_cost=cost,
                    initial_cost=cost_init)


def gn_track_frame(bundle: PointBundle, kf_image_pyr: list, trg_image_pyr: list,
                   K: torch.Tensor, kp_logdepth: torch.Tensor, kp_base: torch.Tensor,
                   T_kf: torch.Tensor, T_init: torch.Tensor, kf_affine: torch.Tensor,
                   affine_init: torch.Tensor, geo_dims: tuple[int, int],
                   levels: Optional[list[int]] = None, max_iters: int = 20,
                   use_affine: bool = False):
    """Coarse-to-fine GN tracking (the counterpart of
    ``odometry.tracker.track_frame``).  Returns (T_frame (4, 4), affine (2,),
    one :class:`GNResult` per level)."""
    R = se3.inverse(T_init) @ T_kf
    affine = affine_init
    levels = list(range(len(kf_image_pyr))) if levels is None else list(levels)
    infos = []
    for lv in levels:
        src = ph.precompute_source(kf_image_pyr[lv], bundle, geo_dims)
        result = gn_track(bundle, src, trg_image_pyr[lv], K, kp_logdepth, kp_base, R, affine,
                          kf_affine, geo_dims, max_iters=max_iters, use_affine=use_affine)
        R, affine = result.R, result.affine
        infos.append(result)
    T_frame = se3.renormalize(T_kf @ se3.inverse(R))
    return T_frame, affine, infos
