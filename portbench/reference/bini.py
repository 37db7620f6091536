"""Plain reference of BiNI, the bilateral normal integration of each
segment's normals into a log-depth field, as the frontend routes it: each
segment solved on the smallest crop window (32, 64, 128) its bounding box
fits at the integration shape, else on the full field.

Frozen copy, at commit 51882e36a88e, of
``super_primitive_tpu_torch/integrate/bini.py`` (coefficients, IRLS
weights, system, crops) and ``ops/stencil.py``'s ``_apply_math`` and
``_cg_one`` (the plain version of kernel K2: Jacobi-PCG with float64 dot
sums, the relative tolerance floored at 5e-7, the best-residual iterate),
here run on all segments of a call at once, each frozen when its own
test stops it, and ``frontend/process_frame.py``'s routing.  It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import nn_resize

CROP_BUCKETS = (32, 64, 128)
K_SHARPNESS = 2.0
OUTER_ITERS = 5


def _shift(x, dr, dc):
    return torch.roll(x, (dr, dc), dims=(-2, -1))


def _edge_masks(m: torch.Tensor) -> dict:
    H, W = m.shape[-2], m.shape[-1]
    col = torch.arange(W, device=m.device)
    row = torch.arange(H, device=m.device)[:, None]
    return {
        "up": m & _shift(m, 0, -1) & (col < W - 1),
        "um": m & _shift(m, 0, 1) & (col > 0),
        "vp": m & _shift(m, -1, 0) & (row < H - 1),
        "vm": m & _shift(m, 1, 0) & (row > 0),
    }


def _diff(zt, d):
    return {"up": lambda: _shift(zt, 0, -1) - zt, "um": lambda: zt - _shift(zt, 0, 1),
            "vp": lambda: _shift(zt, -1, 0) - zt, "vm": lambda: zt - _shift(zt, 1, 0)}[d]()


def _diff_adjoint(y, d):
    return {"up": lambda: _shift(y, 0, 1) - y, "um": lambda: y - _shift(y, 0, -1),
            "vp": lambda: _shift(y, 1, 0) - y, "vm": lambda: y - _shift(y, -1, 0)}[d]()


def _coefficients(normals_crop, K, r0, c0):
    """Per-pixel D, c_u, c_v of (N, h, w, 3) crops whose top-left sits at
    global pixel (r0, c0) (N,)."""
    h, w = normals_crop.shape[-3], normals_crop.shape[-2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    nx, ny, nz = normals_crop[..., 0], normals_crop[..., 1], normals_crop[..., 2]
    dt, dev = normals_crop.dtype, normals_crop.device
    r0 = torch.as_tensor(r0, dtype=dt, device=dev)[..., None, None]
    c0 = torch.as_tensor(c0, dtype=dt, device=dev)[..., None, None]
    col = c0 + torch.arange(w, dtype=dt, device=dev)[None, :] - cx
    row = r0 + torch.arange(h, dtype=dt, device=dev)[:, None] - cy
    D = nx * col / fx + ny * row / fy + nz
    return D, nx / fx, ny / fy


def _weights(zt, D, c_u, c_v, em):
    r_up = D * _diff(zt, "up") + c_u
    r_um = D * _diff(zt, "um") + c_u
    r_vp = D * _diff(zt, "vp") + c_v
    r_vm = D * _diff(zt, "vm") + c_v
    w_u = torch.sigmoid(K_SHARPNESS * (r_um**2 * em["um"] - r_up**2 * em["up"]))
    w_v = torch.sigmoid(K_SHARPNESS * (r_vm**2 * em["vm"] - r_vp**2 * em["vp"]))
    return w_u, w_v


def _system(D, c_u, c_v, em, w_u, w_v):
    wm = {"up": w_u * em["up"], "um": (1.0 - w_u) * em["um"],
          "vp": w_v * em["vp"], "vm": (1.0 - w_v) * em["vm"]}
    q = {d: wm[d] * D * D for d in wm}
    c = {"up": c_u, "um": c_u, "vp": c_v, "vm": c_v}
    b = 0.0
    for d in ("up", "um", "vp", "vm"):
        b = b - _diff_adjoint(wm[d] * D * c[d], d)
    diag = (q["up"] + _shift(q["up"], 0, 1) + q["um"] + _shift(q["um"], 0, -1)
            + q["vp"] + _shift(q["vp"], 1, 0) + q["vm"] + _shift(q["vm"], -1, 0))
    return q, b, diag


def _apply(p, q_up, q_um, q_vp, q_vm):
    """A p = sum_d D_d^T (q_d * D_d p) with wrap-around shifts."""
    def sh(x, dr, dc):
        if dr:
            x = torch.roll(x, dr, dims=-2)
        if dc:
            x = torch.roll(x, dc, dims=-1)
        return x

    y_up = q_up * (sh(p, 0, -1) - p)
    y_um = q_um * (p - sh(p, 0, 1))
    y_vp = q_vp * (sh(p, -1, 0) - p)
    y_vm = q_vm * (p - sh(p, 1, 0))
    return ((sh(y_up, 0, 1) - y_up) + (y_um - sh(y_um, 0, -1))
            + (sh(y_vp, 1, 0) - y_vp) + (y_vm - sh(y_vm, -1, 0)))


def cg(b, x0, mask, diag, q, max_iter: int, tol: float, check_every: int = 8):
    """Jacobi-PCG of every (H, W) segment of (N, H, W) fields, each with
    ``_cg_one``'s arithmetic and stop test; a segment's iterate freezes when
    its own test stops it.  Returns (x, iterations (N,))."""
    b = b * mask
    safe = torch.where(diag > 1e-12, diag, torch.ones_like(diag))
    inv_diag = torch.where(diag > 1e-12, 1.0 / safe, torch.zeros_like(diag))

    def A(p):
        return _apply(p, *q) * mask

    def dot(a, c):
        return torch.sum(a * c * mask, dim=(-2, -1), dtype=torch.float64).to(a.dtype)

    def col(v):
        return v[:, None, None]

    x = x0 * mask
    r = (b - A(x)) * mask
    p = r * inv_diag * mask
    rz = dot(r, p)
    thresh = max(tol, 5e-7) * torch.clamp(torch.sqrt(dot(b, b)), min=1e-30)
    r_norm = torch.sqrt(dot(r, r))
    x_best, best = x, r_norm
    iters = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)

    def running(r_norm, best):
        return ~((r_norm <= thresh) | (r_norm > 10.0 * best + 1e-30))

    active = running(r_norm, best)
    for it in range(max_iter):
        if it % check_every == 0 and not bool(active.any()):
            break
        x_best = torch.where(col(active & (r_norm < best)), x, x_best)
        best = torch.where(active, torch.minimum(best, r_norm), best)
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 1e-30, rz / torch.where(pAp > 1e-30, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        alpha = torch.where(active, alpha, torch.zeros_like(alpha))
        x = x + col(alpha) * p
        r = r - col(alpha) * Ap
        z = r * inv_diag * mask
        rz_new = dot(r, z)
        beta = torch.where(rz > 1e-30, rz_new / torch.where(rz > 1e-30, rz, torch.ones_like(rz)),
                           torch.zeros_like(rz))
        p = torch.where(col(active), z + col(beta) * p, p)
        rz = torch.where(active, rz_new, rz)
        r_norm = torch.where(active, torch.sqrt(dot(r, r)), r_norm)
        iters += active
        active = active & running(r_norm, best)
    return torch.where(col(r_norm < best), x, x_best), iters


def solve(D, c_u, c_v, masks, max_iter: int, tol: float):
    """IRLS with CG given per-pixel coefficients; (N, h, w) log-depth,
    zero outside the masks, gauge-fixed to mean 0 inside, in D's dtype."""
    maskf = masks.to(D.dtype)
    em = {k: v.to(D.dtype) for k, v in _edge_masks(masks).items()}
    zt = torch.zeros_like(maskf)
    w_u = torch.full_like(maskf, 0.5)
    w_v = torch.full_like(maskf, 0.5)
    for _ in range(OUTER_ITERS):
        q, b, diag = _system(D, c_u, c_v, em, w_u, w_v)
        qs = tuple(q[k].expand(maskf.shape) for k in ("up", "um", "vp", "vm"))
        zt, _ = cg(b * maskf, zt, maskf, diag.expand(maskf.shape), qs, max_iter, tol)
        npix = torch.clamp(torch.sum(maskf, dim=(-2, -1)), min=1.0)
        mean = torch.sum(zt * maskf, dim=(-2, -1)) / npix
        zt = (zt - mean[:, None, None]) * maskf
        w_u, w_v = _weights(zt, D, c_u, c_v, em)
    return zt * maskf


def _crop_origins(masks, crop_h, crop_w):
    N, H, W = masks.shape
    any_r = masks.any(dim=2).to(torch.int8)
    any_c = masks.any(dim=1).to(torch.int8)
    top = torch.argmax(any_r, dim=1)
    bottom = H - 1 - torch.argmax(any_r.flip(1), dim=1)
    left = torch.argmax(any_c, dim=1)
    right = W - 1 - torch.argmax(any_c.flip(1), dim=1)
    h, w = bottom - top + 1, right - left + 1
    r0 = torch.clamp(top - torch.div(crop_h - h, 2, rounding_mode="floor"), 0, max(H - crop_h, 0))
    c0 = torch.clamp(left - torch.div(crop_w - w, 2, rounding_mode="floor"), 0, max(W - crop_w, 0))
    return r0, c0


def integrate(normals: torch.Tensor, masks: np.ndarray, K: torch.Tensor, max_iter: int,
              tol: float) -> np.ndarray:
    """Per-segment log-depth (N, Hg, Wg) on the host for (N, Hg, Wg) bool
    masks at the integration shape of (Hg, Wg, 3) ``normals``, each segment
    on its crop bucket or the full field, in the normals' dtype; zero
    outside the masks."""
    N, Hg, Wg = masks.shape
    out = np.zeros((N, Hg, Wg), np.float32)
    any_r, any_c = masks.any(axis=2), masks.any(axis=1)
    nonempty = any_r.any(axis=1)
    hs = np.where(nonempty, Hg - any_r[:, ::-1].argmax(axis=1) - any_r.argmax(axis=1), 0)
    ws = np.where(nonempty, Wg - any_c[:, ::-1].argmax(axis=1) - any_c.argmax(axis=1), 0)
    ext = np.maximum(hs, ws)
    assigned = np.zeros(N, bool)
    dev = normals.device
    m_all = torch.from_numpy(np.ascontiguousarray(masks)).to(dev)
    for c in CROP_BUCKETS:
        sel = (~assigned) & (ext <= c)
        if not sel.any():
            continue
        idx = np.nonzero(sel)[0]
        m = m_all[torch.from_numpy(idx).to(dev)]
        ch, cw = min(c, Hg), min(c, Wg)
        r0, c0 = _crop_origins(m, ch, cw)
        rows = r0[:, None] + torch.arange(ch, device=dev)[None, :]
        cols = c0[:, None] + torch.arange(cw, device=dev)[None, :]
        n_idx = torch.arange(len(idx), device=dev)[:, None, None]
        crop_m = m[n_idx, rows[:, :, None], cols[:, None, :]]
        D, c_u, c_v = _coefficients(normals[rows[:, :, None], cols[:, None, :]], K,
                                    r0.to(normals.dtype), c0.to(normals.dtype))
        zt = solve(D, c_u, c_v, crop_m, max_iter, tol).float().cpu().numpy()
        r0, c0 = r0.cpu().numpy(), c0.cpu().numpy()
        for j, i in enumerate(idx):
            out[i, r0[j]:r0[j] + ch, c0[j]:c0[j] + cw] = zt[j]
        assigned |= sel
    if (~assigned).any():
        idx = np.nonzero(~assigned)[0]
        D, c_u, c_v = _coefficients(normals, K, 0.0, 0.0)
        zt = solve(D, c_u, c_v, m_all[torch.from_numpy(idx).to(dev)], max_iter, tol)
        out[idx] = zt.float().cpu().numpy()
    return out * masks


def resize_masks(masks: np.ndarray, hw) -> np.ndarray:
    """(N, h, w) bool masks nearest-resized to the integration shape."""
    return nn_resize(np.asarray(masks, bool), tuple(hw)).astype(bool)
