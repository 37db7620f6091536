"""Windowed mapping: joint refinement of keyframe log-depths, poses and
affine parameters over chain connectivity with supporting frames.

Port of ``super_primitive_tpu/odometry/mapper.py`` (``build_slots``,
``build_masks``, ``run_mapping``, ``run_supp_refinement``,
``run_supp_refinement_gn``, ``write_back``).  Semantics:

- modes 'init' (first mapping), 'map' (scheduled), 'supp' (per-frame
  refinement of the newest keyframe's log-depths);
- per-group Adam rates: log-depth 1e-2; pose 1e-2 for mono init else 1e-4;
  affine 1e-5; the first window pose always frozen, its log-depths frozen
  when the window is full;
- connectivity: chain +-1 plus the supporting frames of the source and of
  the source before it;
- cost pose for (source s, target t): inv(T_t exp(xi_t)) @ (T_s exp(xi_s));
- per step the tangent folds into the pose (with renormalisation) and
  restarts at zero; Adam moments persist;
- loss = sum over sources of the mean over that source's valid targets;
- early stop once the loss stops changing (relative change < 1e-8) when
  ``early_stop`` is set.

The JAX package's ``lax.while_loop`` becomes a Python loop.  The early stop
reads the loss on the host once per step (a device sync per step), so the
iteration counts equal the JAX package's.  Only valid sources and valid
targets are computed; the JAX package computes every slot and masks.

The GN supp refinement (``run_supp_refinement_gn``) takes a diagonal Newton
step per segment: each point touches one scalar log-depth, so the normal
equations are diagonal.  One forward-mode tangent (``torch.func.jvp``)
gives every point's partial; the per-segment sums are a one-hot matmul
(``solve.gn_mapping.segment_onehot``) in float64, rounded to float32 once:
the same float32 sums on every device and shard layout.

On a window sharded over the mesh (``parallel.mesh.shard_window``) the
points split over sp and, in ``run_mapping``, each source's targets over dp
(``parallel.mesh.shard_targets``).  Each rank backpropagates its partial
loss; the gradients and the loss are summed over the world before Adam's
direction and the early stop read them, so every rank takes the same
steps.  The GN supp refinement sums its diagonal system and costs over sp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cost import photometric as ph
from ..geometry import projection
from ..lie import se3
from ..ops.sampling import bilinear_sample_packed, pack_bilinear_taps
from ..parallel.mesh import reduce_sum, shard_targets
from ..solve.gn_mapping import segment_onehot
from ..solve.retraction_adam import ScaleByAdam
from ..utils.timing import host_flag
from .window import WindowBuffers


class MapSlots(NamedTuple):
    """Connectivity: for each source keyframe slot, up to T_max targets
    indexed into the unified pose table (keyframes first, then supporting
    frames flattened), plus masks."""

    trg_index: np.ndarray     # (W, T_max) int32 into [0, W + W*S)
    trg_valid: np.ndarray     # (W, T_max) bool
    src_valid: np.ndarray     # (W,) bool


class MapMasks(NamedTuple):
    xi_mask: np.ndarray       # (B,) float: pose tangent update mask
    ld_mask: np.ndarray       # (W,) float: log-depth update mask
    affine_mask: np.ndarray   # (B,) float


class MapResult(NamedTuple):
    poses: torch.Tensor       # (B, 4, 4) unified: W keyframes then W*S supp
    kp_logdepth: torch.Tensor  # (W, N)
    affine: torch.Tensor      # (B, 2)
    losses: list              # loss of every step run
    num_iters: int


def build_slots(num_kfs: int, window_cap: int, supp_valid: np.ndarray, mode: str) -> MapSlots:
    """Host-side connectivity construction (odometery.py:451-530)."""
    W = window_cap
    S = supp_valid.shape[1]
    T_max = 2 + 2 * S
    trg_index = np.zeros((W, T_max), np.int32)
    trg_valid = np.zeros((W, T_max), bool)
    src_valid = np.zeros((W,), bool)
    for src in range(num_kfs):
        if mode == "supp" and src != num_kfs - 1:
            continue
        slots = []
        if src > 0:
            slots.append(src - 1)
        if src < num_kfs - 1:
            slots.append(src + 1)
        for s_src in ([src, src - 1] if src > 0 else [src]):
            for j in range(S):
                if supp_valid[s_src, j]:
                    slots.append(W + s_src * S + j)
        if not slots:
            continue
        src_valid[src] = True
        trg_index[src, : len(slots)] = slots
        trg_valid[src, : len(slots)] = True
    # slots are front-packed per source: drop the all-invalid columns
    used = int(trg_valid.any(axis=0).sum())
    keep = 1 if used == 0 else min(T_max, used + (used % 2))
    return MapSlots(trg_index=np.ascontiguousarray(trg_index[:, :keep]),
                    trg_valid=np.ascontiguousarray(trg_valid[:, :keep]),
                    src_valid=src_valid)


def build_masks(num_kfs: int, window_cap: int, supp_valid: np.ndarray, mode: str,
                window_size: int, opt_supporting: bool,
                affine_compensation: bool) -> MapMasks:
    """Which parameters move, per mode (odometery.py:576-650)."""
    W = window_cap
    S = supp_valid.shape[1]
    B = W + W * S
    xi = np.zeros(B, np.float32)
    ld = np.zeros(W, np.float32)
    aff = np.zeros(B, np.float32)
    if mode == "supp":
        if num_kfs > 0:
            ld[num_kfs - 1] = 1.0
    else:
        xi[1:num_kfs] = 1.0                       # first pose always frozen
        start = 1 if num_kfs == window_size else 0
        ld[start:num_kfs] = 1.0                   # first frozen when full
        if affine_compensation:
            aff[1:num_kfs] = 1.0
        if opt_supporting:
            for i in range(num_kfs):
                for j in range(S):
                    if supp_valid[i, j]:
                        xi[W + i * S + j] = 1.0
                        if affine_compensation:
                            aff[W + i * S + j] = 1.0
    return MapMasks(xi_mask=xi, ld_mask=ld, affine_mask=aff)


def _packed_pool(buffers: WindowBuffers, indices) -> dict:
    """Packed bilinear taps of every pool image in ``indices``."""
    pool = buffers.image_pool()
    return {int(k): pack_bilinear_taps(pool[int(k)]) for k in sorted(set(indices))}


def run_mapping(buffers: WindowBuffers, slots: MapSlots, masks: MapMasks,
                lr_pose: float, lr_logdepth: float, lr_affine: float, max_iters: int,
                early_stop: bool, use_affine: bool, geo_dims: tuple[int, int],
                drag_supporting: bool = False) -> MapResult:
    """One mapping solve over the window.  ``drag_supporting`` (set when
    ``opt_supporting`` is off) moves each supporting pose with its source
    keyframe's update instead of freezing it in the world frame."""
    dev = buffers.images.device
    W, S = buffers.capacity, buffers.supp_capacity
    B = W + W * S
    kf_of = torch.cat([torch.arange(W, device=dev), torch.arange(W, device=dev).repeat_interleave(S)])
    is_supp = (torch.arange(B, device=dev) >= W)[:, None]

    poses = buffers.pose_pool().clone()
    ld = buffers.kp_logdepth.clone()
    aff = buffers.affine_pool().clone()

    mesh = buffers.mesh
    sources = []
    for i in np.nonzero(slots.src_valid)[0]:
        idx = slots.trg_index[i][slots.trg_valid[i]].astype(np.int64)
        mine = shard_targets(idx, mesh)
        if len(mine):
            sources.append((int(i), mine, buffers.bundle_at(int(i)), max(len(idx), 1)))
    packed = _packed_pool(buffers, [k for _, idx, _, _ in sources for k in idx])
    sources = [
        (i, torch.as_tensor(idx, device=dev), bundle, buffers.source_samples(i, geo_dims),
         torch.stack([packed[int(k)] for k in idx]), cnt)
        for i, idx, bundle, cnt in sources
    ]
    xi_mask = torch.as_tensor(masks.xi_mask, device=dev)[:, None]
    ld_mask = torch.as_tensor(masks.ld_mask, device=dev)[:, None]
    aff_mask = torch.as_tensor(masks.affine_mask, device=dev)[:, None]

    opt = ScaleByAdam([torch.zeros(B, 6, device=dev), ld, aff])
    losses = []
    prev_loss = float("inf")
    it = 0
    while it < max_iters:
        xi = torch.zeros(B, 6, device=dev, requires_grad=True)
        ld_p = ld.detach().requires_grad_(True)
        aff_p = aff.detach().requires_grad_(True)
        E = poses @ se3.exp(xi)
        total = torch.zeros((), device=dev)
        for i, idx, bundle, src, trg_packed, cnt in sources:
            rel = se3.inverse(E[idx]) @ E[i]
            res = ph.photometric_cost_batch(
                bundle, src, trg_packed, buffers.K[i], geo_dims, ld_p[i],
                buffers.kp_base[i], rel,
                affine=(aff_p[i], aff_p[idx]) if use_affine else None,
            )
            total = total + torch.sum(res) / cnt
        grads = (torch.autograd.grad(total, [xi, ld_p, aff_p], allow_unused=True)
                 if total.requires_grad else (None,) * 3)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, (xi, ld, aff))]
        if mesh is not None:
            *grads, total = reduce_sum((*grads, total.detach()), mesh.world)
        d_xi, d_ld, d_aff = opt.direction(grads)
        with torch.no_grad():
            upd_xi = -lr_pose * d_xi * xi_mask
            if drag_supporting:
                upd_xi = torch.where(is_supp, upd_xi[kf_of], upd_xi)
            poses = se3.retract(poses, upd_xi)
            ld = ld + (-lr_logdepth * d_ld * ld_mask)
            aff = aff + (-lr_affine * d_aff * aff_mask)
        loss = float(total.detach())
        losses.append(loss)
        it += 1
        rel_change = abs(loss - prev_loss) / max(prev_loss, 1e-30)
        if early_stop and rel_change < 1e-8:
            break
        prev_loss = loss
    return MapResult(poses=poses, kp_logdepth=ld, affine=aff, losses=losses, num_iters=it)


def run_supp_refinement(buffers: WindowBuffers, src_slot: int, trg_index: np.ndarray,
                        trg_valid: np.ndarray, lr_logdepth: float, num_iters: int,
                        use_affine: bool, geo_dims: tuple[int, int]):
    """'supp' mapping: refine only the newest keyframe's log-depths against
    its targets, no pose or affine parameters.  Returns kp_logdepth (N,)."""
    dev = buffers.images.device
    s = int(src_slot)
    bundle = buffers.bundle_at(s)
    src = buffers.source_samples(s, geo_dims)
    idx = trg_index[trg_valid].astype(np.int64)
    packed = _packed_pool(buffers, idx)
    trg_packed = torch.stack([packed[int(k)] for k in idx])
    idx_t = torch.as_tensor(idx, device=dev)
    rel = se3.inverse(buffers.pose_pool()[idx_t]) @ buffers.poses[s]
    aff = (buffers.affine[s], buffers.affine_pool()[idx_t]) if use_affine else None

    ld = buffers.kp_logdepth[s].clone()
    opt = ScaleByAdam([ld])
    for _ in range(num_iters):
        ld_p = ld.detach().requires_grad_(True)
        res = ph.photometric_cost_batch(bundle, src, trg_packed, buffers.K[s], geo_dims,
                                        ld_p, buffers.kp_base[s], rel, affine=aff)
        loss = torch.sum(res) / max(len(idx), 1)
        (g,) = torch.autograd.grad(loss, [ld_p])
        (d,) = opt.direction([g])
        with torch.no_grad():
            ld = ld - lr_logdepth * d
    return ld


def _pool_rows(pool: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` (host ints) of a pool, stacked without copying the
    indices to the device (which would wait for the card)."""
    return torch.stack([pool[int(k)] for k in idx])


def run_supp_refinement_gn(buffers: WindowBuffers, src_slot: int, trg_index: np.ndarray,
                           trg_valid: np.ndarray, use_affine: bool, geo_dims: tuple[int, int],
                           max_iters: int = 6):
    """Newton 'supp' refinement of the newest keyframe's log-depths against
    its valid targets, with LM damping on the diagonal system and IRLS-L1
    weights (the Adam path's objective).  Returns (kp_logdepth (N,),
    costs (2,) initial and final, the iterations run)."""
    s = int(src_slot)
    bundle = buffers.bundle_at(s)
    src = buffers.source_samples(s, geo_dims)
    idx = trg_index[trg_valid]
    packed = _packed_pool(buffers, idx)
    trg_packed = torch.stack([packed[int(k)] for k in idx])
    rel = se3.inverse(_pool_rows(buffers.pose_pool(), idx)) @ buffers.poses[s]
    aff_t = _pool_rows(buffers.affine_pool(), idx)
    K, kp_base = buffers.K[s], buffers.kp_base[s]
    N = buffers.kp_logdepth.shape[1]
    onehot = segment_onehot(bundle.seg_id, N)
    nv = float(max(bundle.num_valid, 1))
    group = bundle.group
    cnt = float(max(len(idx), 1))

    def residuals(ld, shift):
        """(T, P, C) residuals with a uniform per-point log-depth tangent."""
        logd = ph.spread_logdepth(bundle, ld, kp_base) + shift
        pts_t = projection.transform(projection.unproject(bundle.uv, torch.exp(logd), K)[None],
                                     rel)
        coords = ph.normalized_image_coords(projection.project(pts_t, K), geo_dims)
        px, ok = bilinear_sample_packed(trg_packed, coords)
        ok = ok & (pts_t[..., 2] > ph.Z_VALID_BATCH)
        if use_affine:
            px = ph.affine_compensate(px, buffers.affine[s], aff_t)
        valid = (src.valid & ok & bundle.valid).to(px.dtype)
        return (src.pixels[..., :3] - px[..., :3]) * valid[..., None], valid

    def cost_of(r):
        per_slot = reduce_sum(torch.sum(torch.abs(r), dim=(1, 2)), group)
        return torch.sum(per_slot / (3.0 * nv)) / cnt

    zero = torch.zeros((), device=K.device)
    one = torch.ones((), device=K.device)
    ld = buffers.kp_logdepth[s]
    cost0 = cost = cost_of(residuals(ld, zero)[0])
    lam = torch.full((), 1e-3, device=K.device)
    it = 0
    while it < max_iters:
        r0, j, valid = torch.func.jvp(lambda sh: residuals(ld, sh), (zero,), (one,),
                                      has_aux=True)
        w = 1.0 / torch.clamp(torch.abs(r0), min=1e-3)
        w = w * valid[..., None] / (3.0 * nv * cnt)
        # the diagonal system, summed per segment in float64, rounded once
        JtJ, Jtr = (x.to(torch.float32) for x in reduce_sum(
            (onehot @ torch.sum(w * j * j, dim=(0, 2)).to(torch.float64),
             onehot @ torch.sum(w * j * r0, dim=(0, 2)).to(torch.float64)), group))
        ld_new = ld - Jtr / (JtJ * (1.0 + lam) + 1e-12)
        cost_new = cost_of(residuals(ld_new, zero)[0])
        improved = cost_new < cost
        ld = torch.where(improved, ld_new, ld)
        lam = torch.where(improved, torch.clamp(lam * 0.33, min=1e-6), lam * 4.0)
        rel_change = torch.abs(cost - cost_new) / torch.clamp(cost, min=1e-30)
        done = (improved & (rel_change < 1e-6)) | (lam > 1e4)
        cost = torch.where(improved, cost_new, cost)
        it += 1
        if host_flag(done):
            break
    return ld, torch.stack([cost0, cost]), it


def write_back(buffers: WindowBuffers, result: MapResult) -> None:
    """Store the optimised poses, log-depths and affines in the window
    (in place)."""
    W, S = buffers.capacity, buffers.supp_capacity
    buffers.poses = result.poses[:W].contiguous()
    buffers.supp_poses = result.poses[W:].reshape(W, S, 4, 4).contiguous()
    buffers.kp_logdepth = result.kp_logdepth
    buffers.affine = result.affine[:W].contiguous()
    buffers.supp_affine = result.affine[W:].reshape(W, S, 2).contiguous()
