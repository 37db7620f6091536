"""Gauss-Newton/LM windowed mapping with a scalar-landmark Schur complement.

Port of ``super_primitive_tpu/solve/gn_mapping.py``.  The mapping problem
(``odometry/mapper.py``) has bundle-adjustment structure: per-segment
scalar log-depths are landmarks (each residual touches one), poses and
affines are cameras.  The normal equations split

    [ D   B ] [dl    ]   [ g_l ]
    [ B^T  H ] [dtheta] = -[ g_t ],   D diagonal over the W*N landmarks,

and reduce by Schur to an M x M solve, M = 8 (W + W*S).

- The Jacobians are closed form, from the same pass as the residual: the
  bilinear interpolant's derivative from the four gathered taps
  (``ops/sampling.bilinear_grad_from_taps``), the projection Jacobian, the
  right-perturbation pose Jacobian [-R [X]_x | R] and dp/dlogdepth = R X.
  The target-pose block reuses the source block through the adjoint.
- ``factored=True`` builds the normal equations from the rank-2 factors
  (J7 = -dIs @ F); ``factored=False`` from the materialised Jacobian.  Same
  math.
- The JAX package's ``lax.scan`` over sources is a Python loop over the
  window's valid sources; each source's valid target slots are batched (the
  JAX package's ``vmap``), their taps fetched from one pooled gather.
  Invalid sources and slots add exact zeros in the JAX package and are not
  computed here.
- Landmark segment sums are a one-hot matmul in float32 (TF32 off), a fixed
  order on every device: no atomic scatter, so two calls on the card agree
  bit for bit.  The camera block's small scatters take each slot's 16
  distinct columns in turn (no duplicate index in one write), and
  :func:`solve_step` scatters the Schur correction through a one-hot
  matmul, since padded slots repeat column indices.
- The LM loop linearizes at the trial point (each iteration is one
  :func:`assemble`); it reads its stop flag on the host once per iteration
  (``utils.timing.host_flag``) and breaks on it, as the JAX package's
  ``lax.while_loop`` stops.
- On a window sharded over sp (``parallel.mesh.shard_window``) each rank
  linearizes its range of every bundle's points, normalised by the global
  point count, and :func:`assemble` ends in one ``reduce_sum`` of (H, g_t,
  D, gl, Bs, cost): every rank then holds the same bits, so the LM accept,
  the damping, the gauge pin and the stop flag agree on every rank.

Not ported: ``tap_dtype`` (bf16 taps were a measured loss on the TPU) and
``point_trim`` (the port's bundles are already trimmed to their valid
points, ``WindowBuffers.bundle_at``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..cost import photometric as ph
from ..geometry import projection
from ..lie import se3, so3
from ..ops.sampling import (
    bilinear_cell_index,
    bilinear_grad_from_taps,
    bilinear_sample,
    bilinear_sample_grad,
    bilinear_sample_grad_packed,
    pack_bilinear_taps,
)
from ..parallel.mesh import reduce_sum
from ..utils.numerics import einsum64
from ..utils.timing import host_flag

_PROJ_EPS = 1e-6  # projection.project's z guard
C = 3


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for the [omega, v] tangent layout:
    Ad = [[R, 0], [hat(t) R, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([so3.hat(t) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


@functools.lru_cache(maxsize=None)
def _coord_scale(geo_dims: tuple[int, int], device: torch.device) -> torch.Tensor:
    """d(normalized coords)/d(pixels), built once per device (a tensor from
    host values on each call would wait for the card)."""
    Hg, Wg = geo_dims
    return torch.tensor([2.0 / (Wg - 1), 2.0 / (Hg - 1)], dtype=torch.float32,
                        device=device)


def linearize_warp_factors(X, src_px, valid_static, rel, K, trg_img, geo_dims, aff_s, aff_t,
                           use_affine: bool, z_valid: float = ph.Z_VALID_BATCH,
                           packed: bool = False, taps=None, taps_hw=None):
    """Rank-2 factors of the photometric-warp Jacobian: the 7 geometry
    columns are J7[p, c, i] = -sum_k dIs[p, c, k] F[p, k, i], with
    ``F = d coords / d [pose(6), logdepth(1)]`` and ``dIs`` the
    (affine-scaled) sampled image gradient.

    ``X`` (P, 3) source points, ``src_px`` (P, C>=3), ``valid_static`` (P,)
    bool, ``rel`` (..., 4, 4) T_target_from_source, ``aff_t`` (..., 2):
    leading slot dimensions batch over targets.  ``packed``: ``trg_img`` is
    a :func:`pack_bilinear_taps` image.  ``taps``: pre-gathered
    ``(tap_rows (..., P, 4C), wx, wy, in_bound)`` from
    :func:`bilinear_cell_index` (``trg_img`` unused), gathered from images of
    dims ``taps_hw`` (default ``geo_dims``).

    Returns (r0 (..., P, 3), valid (..., P) float, dIs (..., P, 3, 2), F
    (..., P, 2, 7), raw3 (..., P, 3) the unscaled samples, ea (..., 1, 1)
    the affine exp factor)."""
    R = rel[..., :3, :3]
    t = rel[..., :3, 3]
    p = projection.transform(X, rel)                              # (..., P, 3)
    if taps is not None:
        tap_rows, t_wx, t_wy, in_bound = taps
        px_raw, dI_dc = bilinear_grad_from_taps(
            tap_rows, t_wx, t_wy, taps_hw if taps_hw is not None else geo_dims)
        trg_ok = in_bound
    else:
        coords = ph.normalized_image_coords(projection.project(p, K), geo_dims)
        sample = bilinear_sample_grad_packed if packed else bilinear_sample_grad
        px_raw, dI_dc, trg_ok = sample(trg_img, coords)
    trg_ok = trg_ok & (p[..., 2] > z_valid)
    valid = (valid_static & trg_ok).to(px_raw.dtype)

    fx, fy = K[0, 0], K[1, 1]
    z = p[..., 2]
    ok_z = torch.abs(z) > _PROJ_EPS
    z_inv = torch.where(ok_z, 1.0 / torch.where(ok_z, z, torch.ones_like(z)),
                        torch.full_like(z, _PROJ_EPS))
    dzinv = torch.where(ok_z, -z_inv * z_inv, torch.zeros_like(z))
    zero = torch.zeros_like(z)
    du_dp = torch.stack([
        torch.stack([fx * z_inv, zero, fx * p[..., 0] * dzinv], dim=-1),
        torch.stack([zero, fy * z_inv, fy * p[..., 1] * dzinv], dim=-1),
    ], dim=-2)                                                    # (..., P, 2, 3)

    # dp/domega = -R [X]_x, written as a broadcast multiply-sum
    dp_dw = -torch.sum(R[..., None, :, :, None] * so3.hat(X)[:, None, :, :], dim=-2)
    dp_dv = R[..., None, :, :].expand(dp_dw.shape)
    dp_dl = (p - t[..., None, :])[..., None]                      # (..., P, 3, 1) = R X
    M7 = torch.cat([dp_dw, dp_dv, dp_dl], dim=-1)                 # (..., P, 3, 7)
    duv_d7 = torch.sum(du_dp[..., :, :, None] * M7[..., None, :, :], dim=-2)
    F = duv_d7 * _coord_scale(tuple(geo_dims), X.device)[:, None]  # (..., P, 2, 7)

    raw3 = px_raw[..., :3]
    if use_affine:
        ea = torch.exp(-(aff_t[..., 0] - aff_s[..., 0]))[..., None, None]
        b = (aff_t[..., 1] - aff_s[..., 1])[..., None, None]
        px = ea * raw3 + b
        dIs = dI_dc[..., :3, :] * ea[..., None]
    else:
        ea = torch.ones(raw3.shape[:-2] + (1, 1), device=raw3.device)
        px = raw3
        dIs = dI_dc[..., :3, :]
    r0 = (src_px[..., :3] - px) * valid[..., None]
    return r0, valid, dIs, F, raw3, ea


def linearize_warp(X, src_px, valid_static, rel, K, trg_img, geo_dims, aff_s, aff_t,
                   use_affine: bool, z_valid: float = ph.Z_VALID_BATCH, packed: bool = False,
                   taps=None, taps_hw=None):
    """Residual and closed-form Jacobian of the photometric warp.

    Returns (r0 (..., P, 3), valid (..., P) float, J (..., P, 3, 11)); the 11
    local columns are [pose tangent (6, right perturbation of ``rel``),
    uniform log-depth shift (1), aff_s (2), aff_t (2)]: ``torch.func.jacfwd``
    of :func:`residual_warp`.  Arguments as :func:`linearize_warp_factors`."""
    r0, valid, dIs, F, raw3, ea = linearize_warp_factors(
        X, src_px, valid_static, rel, K, trg_img, geo_dims, aff_s, aff_t, use_affine,
        z_valid, packed, taps, taps_hw)
    dpx_d7 = torch.sum(dIs[..., None] * F[..., None, :, :], dim=-2)   # (..., P, 3, 7)
    if use_affine:
        ones = torch.ones_like(raw3)
        # r = s - px'; columns [a_s, b_s, a_t, b_t]
        J_aff = torch.stack([-ea * raw3, ones, ea * raw3, -ones], dim=-1)
    else:
        J_aff = torch.zeros(raw3.shape + (4,), device=raw3.device)
    J = torch.cat([-dpx_d7, J_aff], dim=-1) * valid[..., None, None]
    return r0, valid, J


def residual_warp(X, src_px, valid_static, rel0, K, trg_img, geo_dims, aff_s, aff_t,
                  use_affine: bool, local, z_valid: float = ph.Z_VALID_BATCH):
    """The primal residual at an 11-dim local tangent, the Jacobian oracle:
    ``torch.func.jacfwd`` of this equals :func:`linearize_warp`'s J."""
    rel = rel0 @ se3.exp(local[:6])
    p = projection.transform(X * torch.exp(local[6]), rel)
    coords = ph.normalized_image_coords(projection.project(p, K), geo_dims)
    px, trg_ok = bilinear_sample(trg_img, coords)
    trg_ok = trg_ok & (p[..., 2] > z_valid)
    if use_affine:
        px = ph.affine_compensate(px, aff_s + local[7:9], aff_t + local[9:11])
    valid = (valid_static & trg_ok).to(px.dtype)
    return (src_px[..., :3] - px[..., :3]) * valid[..., None], valid


class GNMapResult(NamedTuple):
    poses: torch.Tensor          # (B, 4, 4)
    kp_logdepth: torch.Tensor    # (W, N)
    affine: torch.Tensor         # (B, 2)
    num_iters: int
    initial_cost: torch.Tensor   # () on the device
    final_cost: torch.Tensor


def _src_cols(s: int, B: int) -> np.ndarray:
    return np.concatenate([6 * s + np.arange(6), 6 * B + 2 * s + np.arange(2)])


def col16(s: int, t: int, B: int) -> np.ndarray:
    """Unified-parameter columns of one (source, target) pair's 16 local
    columns: [src pose 6 | trg pose 6 | src affine 2 | trg affine 2]."""
    return np.concatenate([6 * s + np.arange(6), 6 * t + np.arange(6),
                           6 * B + 2 * s + np.arange(2), 6 * B + 2 * t + np.arange(2)])


def build_cmap(trg_index: np.ndarray, B: int) -> np.ndarray:
    """(W, Kc) per-source local-to-global column map: [src pose 6 | src
    affine 2 | slot0 trg pose 6 | slot0 trg affine 2 | slot1 ...]."""
    return np.stack([
        np.concatenate([_src_cols(s, B)] + [_src_cols(int(t), B) for t in trg_index[s]])
        for s in range(trg_index.shape[0])
    ])


def segment_onehot(seg_id: torch.Tensor, N: int) -> torch.Tensor:
    """(N, P) float64 one-hot of each point's segment: ``onehot @ x`` is the
    per-segment sum of a per-point ``x`` (in float64, so that the order the
    device's BLAS picks, and the split over shards, does not show once the
    sum is rounded to float32; see ``utils.numerics.einsum64``)."""
    return (torch.arange(N, device=seg_id.device)[:, None] == seg_id[None, :]).to(torch.float64)


class _Source(NamedTuple):
    """One valid source's constants over an LM solve."""

    s: int
    bundle: object            # PointBundle, trimmed to its valid points
    stride: int
    offset: int               # first kept row: global rows 0, k, 2k, ... are kept
    src_px: torch.Tensor      # (P', C) source samples at the kept points
    vstat: torch.Tensor       # (P',) bool
    onehot: torch.Tensor      # (N, P')
    nv: float                 # points in the objective's mean
    cnt: float                # valid target slots
    slots: np.ndarray         # (Tv,) positions of the valid slots in the row
    tidx: torch.Tensor        # (Tv,) their pool indices
    pool: torch.Tensor        # (Tv*Hp*Wp, 4C) their packed images, flattened
    ix: torch.Tensor          # (Tv, 16) unified columns of each slot


def prepare_sources(buffers, trg_index: np.ndarray, trg_valid: np.ndarray,
                    src_valid: np.ndarray, geo_dims, point_stride: int = 1) -> list:
    """The per-source constants of :func:`assemble`: trimmed bundles, source
    samples, segment one-hots and each source's packed target images."""
    dev = buffers.images.device
    W, S = buffers.capacity, buffers.supp_capacity
    B = W + W * S
    N = buffers.kp_logdepth.shape[1]
    pool = buffers.image_pool()
    packed = {}
    out = []
    for s in np.nonzero(src_valid)[0]:
        s = int(s)
        slots = np.nonzero(trg_valid[s])[0]
        if len(slots) == 0:
            continue
        tlist = [int(t) for t in trg_index[s, slots]]
        for t in tlist:
            if t not in packed:
                packed[t] = pack_bilinear_taps(pool[t])
        bundle = buffers.bundle_at(s)
        src = buffers.source_samples(s, geo_dims)
        k = point_stride
        off = (-bundle.start) % k
        nv = float(max(len(range(0, bundle.num_valid, k)), 1))
        stack = torch.stack([packed[t] for t in tlist])
        out.append(_Source(
            s=s, bundle=bundle, stride=k, offset=off, src_px=src.pixels[off::k],
            vstat=src.valid[off::k], onehot=segment_onehot(bundle.seg_id[off::k], N), nv=nv,
            cnt=float(max(len(slots), 1)), slots=slots,
            tidx=torch.as_tensor(np.asarray(tlist, np.int64), device=dev),
            pool=stack.reshape(-1, stack.shape[-1]),
            ix=torch.as_tensor(np.stack([col16(s, t, B) for t in tlist]), device=dev),
        ))
    return out


def _slot_blocks_factored(r0, valid, dIs, F, raw3, ea, w, use_affine):
    """Per-slot normal-equation blocks from the factors (the (P, 3, 10) J
    never exists).  Returns (H10 (T, 10, 10), g10 (T, 10), d_pt (T, P),
    b_pt (T, P, 10), gl_pt (T, P)); the sums over points H10 and g10 in
    float64 (``einsum64``)."""
    Tv, P = r0.shape[:2]
    wdI = w[..., None] * dIs                                        # (T, P, 3, 2)
    G = torch.sum(wdI[..., :, :, None] * dIs[..., :, None, :], dim=-3)  # (T, P, 2, 2)
    rI = torch.sum(wdI * r0[..., None], dim=-2)                     # (T, P, 2)
    if use_affine:
        era = ea * raw3
        Ar = torch.sum(wdI * era[..., None], dim=-2)
        A1 = torch.sum(wdI, dim=-2)
        s2 = torch.sum(w * era * era, dim=-1)
        s1 = torch.sum(w * era, dim=-1)
        s0 = torch.sum(w, dim=-1)
        u1 = torch.sum(w * era * r0, dim=-1)
        v0 = torch.sum(w * r0, dim=-1)
    else:
        # J_aff is identically zero (linearize_warp's contract)
        Ar = A1 = r0.new_zeros((Tv, P, 2))
        s2 = s1 = s0 = u1 = v0 = r0.new_zeros((Tv, P))
    s2, s1, s0, u1, v0 = (x.to(torch.float64) for x in (s2, s1, s0, u1, v0))

    tmp = torch.sum(G[..., :, :, None] * F[..., None, :, :], dim=-2)   # (T, P, 2, 7)
    H77 = einsum64("tpki,tpkj->tij", F, tmp)
    g7 = -einsum64("tpk,tpki->ti", rI, F)
    Astack = torch.stack([-Ar, A1, Ar, -A1], dim=-1)                # (T, P, 2, 4)
    H7a = -einsum64("tpki,tpkm->tim", F, Astack)
    S2, S1, S0 = s2.sum(-1), s1.sum(-1), s0.sum(-1)
    # Haa[m, n] = sum w Jaff[m] Jaff[n], Jaff = [-er, 1, er, -1]
    Haa = torch.stack([
        torch.stack([S2, -S1, -S2, S1], dim=-1),
        torch.stack([-S1, S0, S1, -S0], dim=-1),
        torch.stack([-S2, S1, S2, -S1], dim=-1),
        torch.stack([S1, -S0, -S1, S0], dim=-1),
    ], dim=-2)
    U1, V0 = u1.sum(-1), v0.sum(-1)
    g_aff = torch.stack([-U1, V0, U1, -V0], dim=-1)
    H10 = torch.cat([torch.cat([H77[:, :6, :6], H7a[:, :6]], dim=-1),
                     torch.cat([H7a[:, :6].transpose(-1, -2), Haa], dim=-1)], dim=-2)
    g10 = torch.cat([g7[:, :6], g_aff], dim=-1)

    tmp6 = tmp[..., 6]                                              # (T, P, 2)
    b7_pt = torch.sum(F * tmp6[..., None], dim=-2)                  # (T, P, 7)
    d_pt = b7_pt[..., 6]
    gl_pt = -torch.sum(F[..., 6] * rI, dim=-1)
    baff_pt = -torch.sum(Astack * F[..., 6][..., None], dim=-2)     # (T, P, 4)
    b_pt = torch.cat([b7_pt[..., :6], baff_pt], dim=-1)             # (T, P, 10)
    return H10, g10, d_pt, b_pt, gl_pt


def _slot_blocks_direct(J, r0, w):
    """Per-slot normal-equation blocks from the materialised Jacobian (T, P,
    3, 11), reduced in the 10-column basis [src pose 6 | affines 4]; H10 and
    g10 in float64."""
    j_l = J[..., 6]
    Jsub = torch.cat([J[..., :6], J[..., 7:11]], dim=-1)
    Jw = Jsub * w[..., None]
    H10 = einsum64("tpci,tpcj->tij", Jw, Jsub)
    g10 = einsum64("tpci,tpc->ti", Jw, r0)
    d_pt = torch.sum(w * j_l * j_l, dim=-1)
    b_pt = torch.sum(Jw * j_l[..., None], dim=-2)
    gl_pt = torch.sum(w * j_l * r0, dim=-1)
    return H10, g10, d_pt, b_pt, gl_pt


def assemble(buffers, trg_index: np.ndarray, trg_valid: np.ndarray, src_valid: np.ndarray,
             par_mask: torch.Tensor, geo_dims, use_affine: bool, poses: torch.Tensor,
             kp_logdepth: torch.Tensor, affine: torch.Tensor, point_stride: int = 1,
             factored: bool = True, sources: list | None = None):
    """One linearization pass of the windowed mapping system.

    ``trg_index``, ``trg_valid``, ``src_valid`` are the host connectivity
    (``mapper.build_slots``); ``sources`` the constants of
    :func:`prepare_sources` (built here when None).  Returns (H (M, M), g_t
    (M,), D (W, N), gl (W, N), Bs (W, N, Kc), cost ()): the camera block,
    camera gradient, landmark diagonal, landmark gradient, landmark-camera
    coupling in per-source block form and the current-state robust cost.
    On a sharded window they are summed over its group.  Every sum over
    points is taken in float64 and rounded to float32 once, after the sum
    over the group: the order of the device's BLAS and the shard layout do
    not show in the float32 result."""
    if sources is None:
        sources = prepare_sources(buffers, trg_index, trg_valid, src_valid, geo_dims,
                                  point_stride)
    dev = poses.device
    W = buffers.capacity
    T_max = trg_index.shape[1]
    N = kp_logdepth.shape[1]
    M = par_mask.shape[0]
    Kc = 8 + 8 * T_max
    Hp, Wp = buffers.images.shape[1:3]
    f64 = dict(device=dev, dtype=torch.float64)
    H = torch.zeros((M, M), **f64)
    g_t = torch.zeros(M, **f64)
    cost = torch.zeros((), **f64)
    D = torch.zeros((W, N), **f64)
    gl = torch.zeros((W, N), **f64)
    Bs = torch.zeros((W, N, Kc), **f64)
    T10 = torch.zeros((10, 16), device=dev)
    T10[:6, :6] = torch.eye(6, device=dev)
    T10[6:, 12:] = torch.eye(4, device=dev)

    for src in sources:
        s, bundle, k = src.s, src.bundle, src.stride
        logd = ph.spread_logdepth(bundle, kp_logdepth[s], buffers.kp_base[s])
        X = projection.unproject(bundle.uv, torch.exp(logd), buffers.K[s])[src.offset::k]
        Tv = src.tidx.shape[0]
        rel0 = se3.inverse(poses[src.tidx]) @ poses[s]                  # (T, 4, 4)
        p = projection.transform(X, rel0)
        coords = ph.normalized_image_coords(projection.project(p, buffers.K[s]), geo_dims)
        # the cell grid is the images' (Hp, Wp), not geo_dims: coarse levels
        # are smaller than the geometry grid
        idx, wx, wy, okb = bilinear_cell_index(coords, (Hp, Wp))
        idx = idx + torch.arange(Tv, device=dev)[:, None] * (Hp * Wp)
        taps = (src.pool[idx], wx, wy, okb)
        aff_t = affine[src.tidx]

        scale = C * src.nv * src.cnt
        if factored:
            r0, valid, dIs, F, raw3, ea = linearize_warp_factors(
                X, src.src_px, src.vstat, rel0, buffers.K[s], None, geo_dims, affine[s],
                aff_t, use_affine, taps=taps, taps_hw=(Hp, Wp))
            w = valid[..., None] / torch.clamp(torch.abs(r0), min=1e-3) / scale
            H10, g10, d_pt, b_pt, gl_pt = _slot_blocks_factored(
                r0, valid, dIs, F, raw3, ea, w, use_affine)
        else:
            r0, valid, J = linearize_warp(
                X, src.src_px, src.vstat, rel0, buffers.K[s], None, geo_dims, affine[s],
                aff_t, use_affine, taps=taps, taps_hw=(Hp, Wp))
            w = valid[..., None] / torch.clamp(torch.abs(r0), min=1e-3) / scale
            H10, g10, d_pt, b_pt, gl_pt = _slot_blocks_direct(J, r0, w)

        # 10 -> 16 columns: the target-pose block is J_t = -J_s Ad(rel^-1)
        Tmat = T10.expand(Tv, 10, 16).clone()
        Tmat[:, :6, 6:12] = -adjoint(se3.inverse(rel0))
        Tmat = Tmat.to(torch.float64)
        m = par_mask[src.ix].to(torch.float64)                           # (T, 16)
        H_loc = (Tmat.transpose(-1, -2) @ H10 @ Tmat) * m[:, :, None] * m[:, None, :]
        g_loc = (Tmat.transpose(-1, -2) @ g10[..., None])[..., 0] * m

        # landmark reduction: one-hot segment matmul, a fixed order
        payload = torch.cat([d_pt[..., None], gl_pt[..., None], b_pt], dim=-1).to(
            torch.float64)                                               # (T, P, 12)
        seg = src.onehot @ payload                                       # (T, N, 12)
        D[s] = seg[..., 0].sum(0)
        gl[s] = seg[..., 1].sum(0)
        bseg = (seg[..., 2:] @ Tmat) * m[:, None, :]                     # (T, N, 16)
        Bs[s, :, :6] = bseg[..., 0:6].sum(0)
        Bs[s, :, 6:8] = bseg[..., 12:14].sum(0)
        for j, slot in enumerate(src.slots):
            c0 = 8 + 8 * int(slot)
            Bs[s, :, c0:c0 + 6] = bseg[j, :, 6:12]
            Bs[s, :, c0 + 6:c0 + 8] = bseg[j, :, 14:16]
            # camera-camera block and gradient: 16 distinct columns a slot
            ix = src.ix[j]
            H[ix[:, None], ix[None, :]] += H_loc[j]
            g_t[ix] += g_loc[j]
        cost_slot = torch.sum(torch.abs(r0).to(torch.float64), dim=(-2, -1)) / (C * src.nv)
        cost = cost + torch.sum(cost_slot) / src.cnt
    return tuple(x.to(torch.float32)
                 for x in reduce_sum((H, g_t, D, gl, Bs, cost), buffers.group))


def solve_step(H, g_t, D, gl, Bs, lam, ld_w, par_mask, cmap):
    """LM-damped Schur-reduced solve of the assembled normal equations.

    ``cmap`` (W, Kc) int64 tensor (:func:`build_cmap`).  Returns (d_theta
    (M,), d_l (W, N))."""
    M = par_mask.shape[0]
    D_d = torch.where(ld_w > 0, D * (1.0 + lam) + 1e-10, torch.ones_like(D))
    D_inv = 1.0 / D_d
    gl_m = gl * ld_w
    Bs_m = Bs * ld_w[..., None]                                     # (W, N, Kc)

    H_d = H + lam * torch.diag(torch.diag(H)) + 1e-8 * torch.eye(M, device=H.device)
    H_d = H_d + torch.diag((par_mask <= 0).to(H.dtype))

    corr = (Bs_m * D_inv[..., None]).transpose(-1, -2) @ Bs_m       # (W, Kc, Kc)
    # scatter-add through a one-hot: padded slots repeat column indices
    E = torch.nn.functional.one_hot(cmap.long(), M).to(H.dtype)     # (W, Kc, M)
    H_red = H_d - torch.einsum("wkm,wkn->mn", E, corr @ E)
    gc = torch.einsum("wnk,wn->wk", Bs_m, D_inv * gl_m)
    g_red = g_t * par_mask - torch.einsum("wkm,wk->m", E, gc)
    d_theta = -torch.linalg.solve_ex(H_red, g_red[:, None])[0][:, 0] * par_mask
    d_l = -(D_inv * (gl_m + torch.einsum("wnk,wk->wn", Bs_m, d_theta[cmap]))) * ld_w
    return d_theta, d_l


def gn_mapping(buffers, trg_index: np.ndarray, trg_valid: np.ndarray, src_valid: np.ndarray,
               xi_mask: np.ndarray, ld_mask: np.ndarray, affine_mask: np.ndarray, geo_dims,
               max_iters: int = 30, use_affine: bool = False, tol: float = 1e-5,
               drag_supporting: bool = False, point_stride: int = 1, factored: bool = True,
               pin_scale_gauge: bool = False) -> GNMapResult:
    """LM over the window's poses, log-depths and affines.

    The connectivity and masks are host arrays (``mapper.build_slots``,
    ``mapper.build_masks``).  ``drag_supporting`` (``opt_supporting`` off)
    moves each supporting pose with its keyframe's step.  ``point_stride``
    k > 1 linearizes on every k-th bundle point.  ``pin_scale_gauge``
    retracts each step onto mean(log-depth) = const along the mono-init
    problem's exact null direction (all landmarks + c, all translations x
    e^c), which LM could otherwise wander along on float32 noise; valid only
    while every frozen pose has zero translation."""
    dev = buffers.images.device
    W, S = buffers.capacity, buffers.supp_capacity
    B = W + W * S
    N = buffers.kp_logdepth.shape[1]

    def dev_f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    par_mask = torch.cat([dev_f32(np.repeat(xi_mask, 6)), dev_f32(np.repeat(affine_mask, 2))])
    ld_w = (dev_f32(ld_mask) * buffers.kf_valid.to(torch.float32))[:, None].expand(W, N)
    cmap = torch.as_tensor(build_cmap(trg_index, B), device=dev)
    sources = prepare_sources(buffers, trg_index, trg_valid, src_valid, geo_dims, point_stride)
    kf_of = torch.cat([torch.arange(W, device=dev), torch.arange(W, device=dev).repeat_interleave(S)])
    is_supp = (torch.arange(B, device=dev) >= W)[:, None]

    def assemble_at(poses, ld, aff):
        return assemble(buffers, trg_index, trg_valid, src_valid, par_mask, geo_dims,
                        use_affine, poses, ld, aff, point_stride, factored, sources)

    def apply_update(poses, ld, aff, d_theta, d_l, D):
        d_xi = d_theta[: 6 * B].reshape(B, 6)
        if drag_supporting:
            d_xi = torch.where(is_supp, d_xi[kf_of], d_xi)
        d_aff = d_theta[6 * B:].reshape(B, 2)
        poses_new = se3.retract(poses, d_xi)
        if pin_scale_gauge:
            # subtract the step's mean log-depth shift over the landmarks
            # that received taps and rescale every translation by e^-c:
            # exactly cost-neutral
            w = ld_w * (D > 1e-12)
            c = torch.sum(d_l * w) / torch.clamp(torch.sum(w), min=1.0)
            d_l = d_l - c * w
            poses_new[:, :3, 3] *= torch.exp(-c)
        return poses_new, ld + d_l, aff + d_aff

    poses, ld, aff = buffers.pose_pool(), buffers.kp_logdepth, buffers.affine_pool()
    lin = assemble_at(poses, ld, aff)
    cost0 = cost = lin[5]
    lam = torch.full((), 1e-3, device=dev)
    it = 0
    while it < max_iters:
        H, g_t, D, gl, Bs, _ = lin
        d_theta, d_l = solve_step(H, g_t, D, gl, Bs, lam, ld_w, par_mask, cmap)
        poses_n, ld_n, aff_n = apply_update(poses, ld, aff, d_theta, d_l, D)
        lin_n = assemble_at(poses_n, ld_n, aff_n)
        cost_n = lin_n[5]
        improved = cost_n < cost
        poses = torch.where(improved, poses_n, poses)
        ld = torch.where(improved, ld_n, ld)
        aff = torch.where(improved, aff_n, aff)
        lin = tuple(torch.where(improved, a, b) for a, b in zip(lin_n, lin))
        lam = torch.where(improved, torch.clamp(lam * 0.33, min=1e-7), lam * 4.0)
        rel = torch.abs(cost - cost_n) / torch.clamp(cost, min=1e-30)
        done = (improved & (rel < tol)) | (lam > 1e5)
        cost = torch.where(improved, cost_n, cost)
        it += 1
        if host_flag(done):
            break
    return GNMapResult(poses=poses, kp_logdepth=ld, affine=aff, num_iters=it,
                       initial_cost=cost0, final_cost=cost)
