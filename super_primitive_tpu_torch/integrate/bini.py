"""Batched bilateral normal integration (BiNI), matrix-free.

Port of ``super_primitive_tpu/integrate/bini.py``.  Per segment it solves
the weighted least-squares normal equations of the perspective BiNI
constraints for the log-depth zt:

    A zt = b,   A = sum_d G_d^T diag(q_d) G_d,   q_d = w_d m_d D^2,
    b = -sum_d G_d^T (w_d m_d D c_d),

over the four one-sided differences G_d, with IRLS updates of the
bilateral weights w_d (outer iterations) and Jacobi-preconditioned CG
inside.  The per-segment constant of zt is fixed to mean 0 in the mask.

The CG runs on the stencil kernels of ``ops/stencil.py``: a field small
enough for one thread-block cluster goes to K2 (the whole CG per segment),
a larger one to ``_pcg`` here, which calls K1 once per iteration.

``group`` shards the segments over a process group
(``parallel.mesh.shard_rows``): each rank solves its contiguous block of
segments and ``gather_rows`` returns them in the unsharded order.  K2 and
``_pcg`` freeze each segment on its own and the global stop only ends the
loop, so a segment's result does not depend on the others in its batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import stencil
from ..parallel.mesh import gather_rows, shard_rows
from ..utils import timing

# Routing: a field goes to K2 where ``stencil.cg_holds`` says K2's plan
# holds it on chip, at most 16 CTAs of at most ``stencil.K2_BAND_PIXELS_MAX``
# pixels each (81,920 pixels at most, fewer for wide fields), and to
# ``_pcg`` on K1 otherwise.  The JAX package routes on the TPU's 8 MiB of
# VMEM instead (bini.py:258-260, ten f32 fields, 209,715 pixels).  The
# H100 times of both routes at fields on either side are in PERF.md
# (``eval/compare_k2.py --routes``).


@dataclasses.dataclass(frozen=True)
class BiniConfig:
    k: float = 2.0              # bilateral sigmoid sharpness
    outer_iters: int = 5        # IRLS weight updates
    cg_max_iter: int = 1000
    cg_tol: float = 1e-3


def _shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Roll an (..., H, W) field by (dr, dc).  It wraps around; the edge
    masks make every wrapped term vanish."""
    return torch.roll(x, (dr, dc), dims=(-2, -1))


def _edge_masks(mask: torch.Tensor) -> dict:
    """Validity of the 4 one-sided differences: both endpoints in mask, and
    the wrapped border side explicitly invalid."""
    m = mask
    H, W = m.shape[-2], m.shape[-1]
    col = torch.arange(W, device=m.device)
    row = torch.arange(H, device=m.device)[:, None]
    return {
        "up": m & _shift(m, 0, -1) & (col < W - 1),
        "um": m & _shift(m, 0, 1) & (col > 0),
        "vp": m & _shift(m, -1, 0) & (row < H - 1),
        "vm": m & _shift(m, 1, 0) & (row > 0),
    }


def _diff(zt: torch.Tensor, d: str) -> torch.Tensor:
    """One-sided difference: forward zt(p + e) - zt(p), backward
    zt(p) - zt(p - e)."""
    if d == "up":
        return _shift(zt, 0, -1) - zt
    if d == "um":
        return zt - _shift(zt, 0, 1)
    if d == "vp":
        return _shift(zt, -1, 0) - zt
    if d == "vm":
        return zt - _shift(zt, 1, 0)
    raise ValueError(d)


def _diff_adjoint(y: torch.Tensor, d: str) -> torch.Tensor:
    """Adjoint of :func:`_diff`."""
    if d == "up":
        return _shift(y, 0, 1) - y
    if d == "um":
        return y - _shift(y, 0, -1)
    if d == "vp":
        return _shift(y, 1, 0) - y
    if d == "vm":
        return y - _shift(y, -1, 0)
    raise ValueError(d)


def _coefficients(normals: torch.Tensor, K: torch.Tensor):
    """Per-pixel D, c_u = nx/fx, c_v = ny/fy for (H, W, 3) normals."""
    return _coefficients_window(normals, K, 0.0, 0.0)


def _coefficients_window(normals_crop, K, r0, c0):
    """Per-pixel D, c_u, c_v of an (h, w, 3) crop whose top-left sits at
    global pixel (r0, c0); r0 and c0 are floats or (N,) tensors for a batch
    of (N, h, w, 3) crops."""
    h, w = normals_crop.shape[-3], normals_crop.shape[-2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    nx, ny, nz = normals_crop[..., 0], normals_crop[..., 1], normals_crop[..., 2]
    dt, dev = normals_crop.dtype, normals_crop.device
    r0 = torch.as_tensor(r0, dtype=dt, device=dev)[..., None, None]
    c0 = torch.as_tensor(c0, dtype=dt, device=dev)[..., None, None]
    col = c0 + torch.arange(w, dtype=dt, device=dev)[None, :] - cx
    row = r0 + torch.arange(h, dtype=dt, device=dev)[:, None] - cy
    D = nx * col / fx + ny * row / fy + nz
    return D, nx / fx, ny / fy


def _weights_from_residuals(zt, D, c_u, c_v, em, k):
    """Bilateral sigmoid weights for the forward sides:
    w = sigmoid(k * (r_minus^2 - r_plus^2))."""
    r_up = D * _diff(zt, "up") + c_u
    r_um = D * _diff(zt, "um") + c_u
    r_vp = D * _diff(zt, "vp") + c_v
    r_vm = D * _diff(zt, "vm") + c_v
    w_u = torch.sigmoid(k * (r_um**2 * em["um"] - r_up**2 * em["up"]))
    w_v = torch.sigmoid(k * (r_vm**2 * em["vm"] - r_vp**2 * em["vp"]))
    return w_u, w_v


def _system(D, c_u, c_v, em, w_u, w_v):
    """Per-edge quadratic weights q_d, rhs b and Jacobi diagonal."""
    q = {
        "up": w_u * em["up"] * D * D,
        "um": (1.0 - w_u) * em["um"] * D * D,
        "vp": w_v * em["vp"] * D * D,
        "vm": (1.0 - w_v) * em["vm"] * D * D,
    }
    c = {"up": c_u, "um": c_u, "vp": c_v, "vm": c_v}
    wm = {
        "up": w_u * em["up"],
        "um": (1.0 - w_u) * em["um"],
        "vp": w_v * em["vp"],
        "vm": (1.0 - w_v) * em["vm"],
    }
    b = 0.0
    for d in ("up", "um", "vp", "vm"):
        b = b - _diff_adjoint(wm[d] * D * c[d], d)
    # diag(A): q_d at p plus the neighbour's q_d shifted back onto p
    diag = (
        q["up"] + _shift(q["up"], 0, 1)
        + q["um"] + _shift(q["um"], 0, -1)
        + q["vp"] + _shift(q["vp"], 1, 0)
        + q["vm"] + _shift(q["vm"], -1, 0)
    )
    return q, b, diag


def _masked_dot(a, b, mask):
    return torch.sum(a * b * mask, dim=(-2, -1))


def _pcg(apply_A, b, x0, mask, diag, max_iter, tol):
    """Batched Jacobi-PCG on (N, H, W) fields; ``apply_A(p) -> (Ap, pAp)``.

    Per-segment freeze; global stop when every segment converged,
    stagnated, or ``max_iter`` elapsed.  fp32 CG run past its precision
    slowly diverges, so the relative tolerance is floored at 5e-7, the
    best-residual iterate is returned, and a segment whose residual grows
    10x above its best is frozen.  Returns (x, iterations)."""
    inv_diag = torch.where(
        diag > 1e-12, 1.0 / torch.where(diag > 1e-12, diag, torch.ones_like(diag)),
        torch.zeros_like(diag),
    )
    maskf = mask.to(b.dtype)

    def precond(r):
        return r * inv_diag * maskf

    def seg_active(r_norm, best):
        return ~((r_norm <= thresh) | (r_norm > 10.0 * best + 1e-30))

    x = x0 * maskf
    r = (b - apply_A(x)[0]) * maskf
    z = precond(r)
    p = z
    rz = _masked_dot(r, z, maskf)
    b_norm = torch.sqrt(_masked_dot(b, b, maskf))
    thresh = max(tol, 5e-7) * torch.clamp(b_norm, min=1e-30)
    best = torch.sqrt(_masked_dot(r, r, maskf))
    x_best = x
    it = 0
    r_norm = best
    while it < max_iter and timing.host_flag(seg_active(r_norm, best).any()):
        improved = (r_norm < best)[:, None, None]
        x_best = torch.where(improved, x, x_best)
        best = torch.minimum(best, r_norm)

        active = seg_active(r_norm, best).to(b.dtype)[:, None, None]
        Ap, pAp = apply_A(p)
        alpha = torch.where(
            pAp > 1e-30, rz / torch.where(pAp > 1e-30, pAp, torch.ones_like(pAp)),
            torch.zeros_like(pAp),
        )
        alpha = alpha[:, None, None] * active
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = _masked_dot(r, z, maskf)
        beta = torch.where(
            rz > 1e-30, rz_new / torch.where(rz > 1e-30, rz, torch.ones_like(rz)),
            torch.zeros_like(rz),
        )
        p = z + beta[:, None, None] * p * active
        rz = rz_new
        r_norm = torch.sqrt(_masked_dot(r, r, maskf))
        it += 1
    # the final iterate may beat the recorded best
    x_best = torch.where((r_norm < best)[:, None, None], x, x_best)
    return x_best, it


def _solve_given_coeffs(D, c_u, c_v, masks, config: BiniConfig, plain: bool = False):
    """IRLS + PCG given per-pixel coefficients.

    ``D``, ``c_u``, ``c_v`` broadcast against (N, h, w) masks: shared
    (h, w) fields for the full-frame path, per-segment (N, h, w) for crops.
    ``plain=True`` runs the stencil's plain versions on any device, so the
    kernels can be held against them."""
    maskf = masks.to(torch.float32)
    em = {k_: v.to(torch.float32) for k_, v in _edge_masks(masks).items()}

    zt = torch.zeros_like(maskf)
    w_u = torch.full_like(maskf, 0.5)
    w_v = torch.full_like(maskf, 0.5)

    apply_fn = stencil.bini_apply_reference if plain else stencil.bini_apply
    cg_fn = stencil.bini_cg_reference if plain else stencil.bini_cg
    in_kernel = stencil.cg_holds(maskf.shape[-2], maskf.shape[-1])

    for _ in range(config.outer_iters):
        q, b, diag = _system(D, c_u, c_v, em, w_u, w_v)
        q_up, q_um, q_vp, q_vm = (
            q[k].expand(maskf.shape).contiguous() for k in ("up", "um", "vp", "vm")
        )
        if in_kernel:
            zt, _ = cg_fn(
                (b * maskf).contiguous(), zt.contiguous(), maskf,
                diag.expand(maskf.shape).contiguous(), q_up, q_um, q_vp, q_vm,
                int(config.cg_max_iter), float(config.cg_tol),
            )
        else:
            zt, _ = _pcg(
                lambda x: apply_fn(x, q_up, q_um, q_vp, q_vm),
                b * maskf, zt, masks, diag, config.cg_max_iter, config.cg_tol,
            )
        # gauge fix before the weight update for numerical stability
        npix = torch.clamp(torch.sum(maskf, dim=(-2, -1)), min=1.0)
        mean = torch.sum(zt * maskf, dim=(-2, -1)) / npix
        zt = (zt - mean[:, None, None]) * maskf
        w_u, w_v = _weights_from_residuals(zt, D, c_u, c_v, em, config.k)

    return zt * maskf


def integrate_normals(
    normals: torch.Tensor,
    masks: torch.Tensor,
    K: torch.Tensor,
    config: BiniConfig = BiniConfig(),
    plain: bool = False,
    group=None,
) -> torch.Tensor:
    """Integrate (H, W, 3) normals inside each of N segment masks.

    Returns per-segment log-depth fields (N, H, W), zero outside the mask
    and gauge-fixed to mean 0 inside.  ``group``: the segments shard over
    it (module docstring)."""
    masks, part = shard_rows(masks.to(torch.bool), group)
    D, c_u, c_v = _coefficients(normals, K)
    return gather_rows(_solve_given_coeffs(D, c_u, c_v, masks, config, plain), part)


def crop_origins(masks: torch.Tensor, crop_h: int, crop_w: int):
    """Top-left (r0, c0) (N,) of the crop_h x crop_w window centred on each
    mask's bounding box, clipped to the field."""
    N, H, W = masks.shape
    any_r = masks.any(dim=2).to(torch.int8)
    any_c = masks.any(dim=1).to(torch.int8)
    top = torch.argmax(any_r, dim=1)
    bottom = H - 1 - torch.argmax(any_r.flip(1), dim=1)
    left = torch.argmax(any_c, dim=1)
    right = W - 1 - torch.argmax(any_c.flip(1), dim=1)
    h = bottom - top + 1
    w = right - left + 1
    r0 = torch.clamp(top - torch.div(crop_h - h, 2, rounding_mode="floor"), 0, max(H - crop_h, 0))
    c0 = torch.clamp(left - torch.div(crop_w - w, 2, rounding_mode="floor"), 0, max(W - crop_w, 0))
    return r0, c0


def integrate_normals_cropped(
    normals: torch.Tensor,
    masks: torch.Tensor,
    K: torch.Tensor,
    config: BiniConfig = BiniConfig(),
    crop: int = 128,
    return_crops: bool = False,
    plain: bool = False,
    group=None,
):
    """Crop-based integration: each segment solves on a crop x crop window
    around its bounding box instead of the full field.

    Exact for segments whose bbox fits the window (the system only couples
    in-mask pixels); larger ones are truncated, so callers route those to
    :func:`integrate_normals`.  Returns (N, H, W) log-depth fields, or with
    ``return_crops`` the tuple (zt_crops (N, ch, cw), r0 (N,), c0 (N,)).
    ``group``: the segments shard over it (module docstring)."""
    masks, part = shard_rows(masks.to(torch.bool), group)
    N, H, W = masks.shape
    crop_h = min(crop, H)
    crop_w = min(crop, W)
    r0, c0 = crop_origins(masks, crop_h, crop_w)

    rows = r0[:, None] + torch.arange(crop_h, device=masks.device)[None, :]   # (N, ch)
    cols = c0[:, None] + torch.arange(crop_w, device=masks.device)[None, :]   # (N, cw)
    crops_n = normals[rows[:, :, None], cols[:, None, :]]                     # (N, ch, cw, 3)
    n_idx = torch.arange(N, device=masks.device)[:, None, None]
    crops_m = masks[n_idx, rows[:, :, None], cols[:, None, :]]                # (N, ch, cw)

    D, c_u, c_v = _coefficients_window(
        crops_n, K, r0.to(normals.dtype), c0.to(normals.dtype)
    )
    zt_crops = _solve_given_coeffs(D, c_u, c_v, crops_m, config, plain)
    if return_crops:
        return tuple(gather_rows(t, part) for t in (zt_crops, r0, c0))
    out = torch.zeros((N, H, W), dtype=zt_crops.dtype, device=zt_crops.device)
    out[n_idx, rows[:, :, None], cols[:, None, :]] = zt_crops
    return gather_rows(out * masks.to(out.dtype), part)


def segment_bbox_sizes(masks_np):
    """Host-side bbox extents (h, w) per segment for crop/full routing."""
    masks_np = np.asarray(masks_np, bool)
    _, H, W = masks_np.shape
    any_r = masks_np.any(axis=2)
    any_c = masks_np.any(axis=1)
    nonempty = any_r.any(axis=1)
    top = any_r.argmax(axis=1)
    bottom = H - 1 - any_r[:, ::-1].argmax(axis=1)
    left = any_c.argmax(axis=1)
    right = W - 1 - any_c[:, ::-1].argmax(axis=1)
    hs = np.where(nonempty, bottom - top + 1, 0).astype(np.int64)
    ws = np.where(nonempty, right - left + 1, 0).astype(np.int64)
    return hs, ws
