"""BiNI stencil kernels K1 (apply) and K2 (whole CG), with plain versions.

Port of ``super_primitive_tpu/ops/pallas_stencil.py``.  The Pallas TPU
kernels ``bini_apply_pallas`` and ``bini_cg_pallas`` become CUDA C++
kernels for Hopper (``csrc/bini_apply.cu``, ``csrc/bini_cg.cu``), built by
``_build`` at first use.

Dispatch is on the device of the tensors: a CUDA tensor launches the
kernel (and a kernel that cannot launch raises), a CPU tensor takes the
plain PyTorch version.  The plain versions ``bini_apply_reference`` and
``bini_cg_reference`` repeat the kernels' math; besides the CPU they serve
the tests and ``chip_smoke.py``, which hold each kernel against them.

K2 runs each segment's whole CG on one thread-block cluster, laid out by
``cg_plan``, a pure function of the field's shape.

Each wrapper adds one to ``launch_counts[name]`` per kernel launch and
nowhere else, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

launch_counts = {"bini_apply": 0, "bini_cg": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _apply_math(p, q_up, q_um, q_vp, q_vm):
    """A p = sum_d D_d^T (q_d * D_d p) over the four one-sided differences,
    with wrap-around (roll) shifts.

    forward-u diff:  d(p)[r, c] = p[r, c+1] - p[r, c]
    its adjoint:     a(y)[r, c] = y[r, c-1] - y[r, c]
    (and symmetric for the other three directions)
    """
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
    return (
        (sh(y_up, 0, 1) - y_up)
        + (y_um - sh(y_um, 0, -1))
        + (sh(y_vp, 1, 0) - y_vp)
        + (y_vm - sh(y_vm, -1, 0))
    )


def bini_apply_reference(p, q_up, q_um, q_vp, q_vm):
    """Plain version of K1: (Ap (N, H, W), <p, Ap> (N,))."""
    ap = _apply_math(p, q_up, q_um, q_vp, q_vm)
    return ap, torch.sum(p * ap, dim=(-2, -1))


def _cg_one(b, x0, mask, diag, q, max_iter: int, tol: float):
    """Jacobi-PCG of one (H, W) segment, the math of ``_cg_kernel_body``.
    Returns (best iterate, iterations run)."""
    b = b * mask
    inv_diag = torch.where(
        diag > 1e-12, 1.0 / torch.where(diag > 1e-12, diag, torch.ones_like(diag)),
        torch.zeros_like(diag),
    )

    def apply_A(p):
        return _apply_math(p, *q) * mask

    def dot(a, c):
        # float32 products summed in float64, as K2 sums them
        return torch.sum(a * c * mask, dtype=torch.float64).to(a.dtype)

    x = x0 * mask
    r = (b - apply_A(x)) * mask
    z = r * inv_diag * mask
    p = z
    rz = dot(r, z)
    b_norm = torch.sqrt(dot(b, b))
    thresh = max(tol, 5e-7) * torch.clamp(b_norm, min=1e-30)
    r_norm = torch.sqrt(dot(r, r))
    x_best, best, it = x, r_norm, 0

    while it < max_iter and not bool((r_norm <= thresh) | (r_norm > 10.0 * best + 1e-30)):
        if bool(r_norm < best):
            x_best = x
        best = torch.minimum(best, r_norm)
        Ap = apply_A(p)
        pAp = dot(p, Ap)
        alpha = rz / pAp if bool(pAp > 1e-30) else torch.zeros_like(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * inv_diag * mask
        rz_new = dot(r, z)
        beta = rz_new / rz if bool(rz > 1e-30) else torch.zeros_like(rz)
        p = z + beta * p
        rz = rz_new
        r_norm = torch.sqrt(dot(r, r))
        it += 1
    return (x if bool(r_norm < best) else x_best), it


def bini_cg_reference(b, x0, mask, diag, q_up, q_um, q_vp, q_vm,
                      max_iter: int, tol: float):
    """Plain version of K2: a loop over segments, each solved on its own.
    Returns (x (N, H, W), iterations (N,) int32)."""
    out = torch.empty_like(b)
    iters = torch.zeros(b.shape[0], dtype=torch.int32)
    for n in range(b.shape[0]):
        q = (q_up[n], q_um[n], q_vp[n], q_vm[n])
        out[n], iters[n] = _cg_one(b[n], x0[n], mask[n], diag[n], q, max_iter, tol)
    return out, iters.to(b.device)


def _check_fields(name: str, fields) -> tuple[int, int, int]:
    """Shape, type, device and layout checks before a kernel launch."""
    ref = fields[0]
    if ref.dim() != 3:
        raise ValueError(f"{name}: fields must be (N, H, W), got {tuple(ref.shape)}")
    for t in fields:
        if t.device != ref.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: every field must be float32 on {ref.device}")
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: fields must be contiguous")
    N, H, W = ref.shape
    if N * H * W >= 2**31 or N > 65535:
        raise ValueError(f"{name}: field of {N}x{H}x{W} is too large")
    return N, H, W


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib_apply():
    lib = _build.library("bini_apply.cu")
    if not getattr(lib, "_typed", False):
        lib.bini_apply_launch.argtypes = [_P] * 8 + [_I, _I, _I, _P]
        lib.bini_apply_launch.restype = _I
        lib.bini_apply_tile_pixels.argtypes = []
        lib.bini_apply_tile_pixels.restype = _I
        lib._typed = True
    return lib


def _lib_cg():
    lib = _build.library("bini_cg.cu")
    if not getattr(lib, "_typed", False):
        lib.bini_cg_launch.argtypes = [_P] * 10 + [_I] * 4 + [ctypes.c_float] + [_I] * 2 + [_P]
        lib.bini_cg_launch.restype = _I
        lib.bini_cg_max_clusters.argtypes = [_I] * 4
        lib.bini_cg_max_clusters.restype = _I
        lib._typed = True
    return lib


class CgPlan(NamedTuple):
    """How K2 lays one (H, W) segment out: a cluster of ``cluster`` CTAs of
    ``threads`` threads, each holding a band of rows in ``smem_bytes`` of
    shared memory."""

    cluster: int
    threads: int
    smem_bytes: int


# What one CTA can hold (``csrc/bini_cg.cu``, which repeats these figures,
# works out the shared memory itself and refuses a plan it does not hold):
# the shared memory a CTA can opt into on the H100, the largest
# non-portable cluster, and the largest CTA for each count of pixels a
# thread owns (registers: x, r and Ap of each owned pixel).
K2_SMEM_BYTES_MAX = 232_448
K2_MAX_CLUSTER = 16
K2_THREADS_BY_PIXELS = ((2, 1024), (4, 1024), (8, 640))
K2_BAND_PIXELS_MAX = max(ppt * t for ppt, t in K2_THREADS_BY_PIXELS)
# Shared memory: 136 doubles for the reductions, then eight floats a band
# pixel (p, q_up, q_um, 1/diag, mask, the best iterate, q_vp, q_vm) and
# eight a column (q_vp's and q_vm's halo rows, p's two halo rows, and the
# mailbox of the band's edge rows: p and z of its first and last row).
_K2_REDUCE_BYTES = 8 * 136
_K2_BAND_FIELDS = 8
_K2_COLUMN_FIELDS = 8
# The plan by field pixels: the first entry (pixels, cluster, pixels a
# thread) whose pixel count is at least the field's; a field larger than
# all takes 16 CTAs of 2 pixels a thread.  From the sweep on the H100
# (PERF.md, ``eval/compare_k2.py --sweep``).
K2_PLAN_BY_PIXELS = ((32 * 32, 1, 2), (64 * 64, 8, 2), (128 * 128, 8, 4))


def cg_smem_bytes(rows_max: int, W: int) -> int:
    """K2's shared memory a CTA for bands of at most ``rows_max`` rows of W."""
    return _K2_REDUCE_BYTES + 4 * (_K2_BAND_FIELDS * rows_max * W + _K2_COLUMN_FIELDS * W)


def cg_pixels_per_thread(H: int, W: int, cluster: int, threads: int) -> int:
    """The pixels each thread owns when ``cluster`` CTAs of ``threads``
    threads hold an (H, W) segment (2, 4 or 8): the fewest that cover the
    largest band.  0 where they do not hold it."""
    if not (1 <= cluster <= min(K2_MAX_CLUSTER, H) and W >= 1
            and 32 <= threads <= 1024 and threads % 32 == 0):
        return 0
    rows_max = -(-H // cluster)
    if cg_smem_bytes(rows_max, W) > K2_SMEM_BYTES_MAX:
        return 0
    for ppt, t_max in K2_THREADS_BY_PIXELS:
        if rows_max * W <= ppt * threads and threads <= t_max:
            return ppt
    return 0


def _plan_for_cluster(H: int, W: int, C: int, ppt_min: int) -> CgPlan | None:
    """The plan with C CTAs and the fewest pixels a thread, at least
    ``ppt_min``, that cover a band of ceil(H / C) rows, or None where none
    does or the band does not fit one CTA's shared memory."""
    rows_max = -(-H // C)
    smem = cg_smem_bytes(rows_max, W)
    if smem > K2_SMEM_BYTES_MAX:
        return None
    for ppt, t_max in K2_THREADS_BY_PIXELS:
        T = 32 * -(-rows_max * W // (32 * ppt))  # whole warps
        if ppt >= ppt_min and T <= t_max:
            return CgPlan(C, T, smem)
    return None


def _find_plan(H: int, W: int) -> CgPlan | None:
    if H < 1 or W < 1:
        return None
    first, ppt = next(((c, t) for n, c, t in K2_PLAN_BY_PIXELS if H * W <= n),
                      (K2_MAX_CLUSTER, 2))
    for C in range(min(first, H), min(K2_MAX_CLUSTER, H) + 1):
        plan = _plan_for_cluster(H, W, C, ppt)
        if plan is not None:
            return plan
    return None


def cg_holds(H: int, W: int) -> bool:
    """Whether K2 holds an (H, W) segment, i.e. ``cg_plan`` has a plan for
    it.  BiNI routes on this: a field K2 holds takes K2, any other the
    K1-per-iteration CG."""
    return _find_plan(H, W) is not None


def cg_plan(H: int, W: int) -> CgPlan:
    """K2's launch plan for an (H, W) segment, a pure function of the shape.

    The cluster size and pixels a thread come from ``K2_PLAN_BY_PIXELS``
    (at most H CTAs); where its bands are too large for one CTA, the next
    larger cluster that holds them.  Raises ValueError where no cluster of
    at most min(16, H) CTAs cuts the field into bands that one CTA holds:
    at most ``K2_BAND_PIXELS_MAX`` pixels in at most ``K2_SMEM_BYTES_MAX``
    bytes of shared memory (``cg_smem_bytes``), tested at ceil(H / min(16,
    H)) rows of W."""
    plan = _find_plan(H, W)
    if plan is None:
        c_max = min(K2_MAX_CLUSTER, max(H, 1))
        raise ValueError(
            f"bini_cg: no plan holds a {H}x{W} field: bands of ceil({H}/{c_max}) "
            f"rows of {W} exceed what one CTA holds ({K2_BAND_PIXELS_MAX} pixels, "
            f"{K2_SMEM_BYTES_MAX} bytes)")
    return plan


@functools.lru_cache(maxsize=None)
def _check_schedulable(device_index: int, H: int, W: int, plan: CgPlan) -> None:
    """Raise unless the card can hold at least one cluster of the plan."""
    with torch.cuda.device(device_index):
        n = _lib_cg().bini_cg_max_clusters(H, W, plan.cluster, plan.threads)
    if n <= 0:
        why = "cannot schedule it" if n == 0 else f"CUDA error {-n}"
        raise RuntimeError(f"bini_cg: plan {plan} for {H}x{W}: the card {why}")


def bini_apply(p, q_up, q_um, q_vp, q_vm):
    """K1: fused A-apply over (N, H, W) fields -> (Ap (N, H, W), <p, Ap> (N,))."""
    if p.device.type == "cpu":
        return bini_apply_reference(p, q_up, q_um, q_vp, q_vm)
    if p.device.type != "cuda":
        raise ValueError(f"bini_apply: no kernel for device {p.device}")
    N, H, W = _check_fields("bini_apply", (p, q_up, q_um, q_vp, q_vm))
    lib = _lib_apply()
    tiles = -(-(H * W) // lib.bini_apply_tile_pixels())
    ap = torch.empty_like(p)
    dots = torch.empty(N, dtype=p.dtype, device=p.device)
    partial = torch.empty(N * tiles, dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        err = lib.bini_apply_launch(
            p.data_ptr(), q_up.data_ptr(), q_um.data_ptr(), q_vp.data_ptr(),
            q_vm.data_ptr(), ap.data_ptr(), partial.data_ptr(), dots.data_ptr(),
            N, H, W, _stream(p),
        )
    if err:
        raise RuntimeError(f"bini_apply: kernel launch failed with CUDA error {err}")
    launch_counts["bini_apply"] += 1
    return ap, dots


def bini_cg(b, x0, mask, diag, q_up, q_um, q_vp, q_vm, max_iter: int, tol: float):
    """K2: per-segment Jacobi-PCG over (N, H, W) fields, each segment on its
    own cluster of CTAs laid out by ``cg_plan(H, W)`` (which raises for a
    shape it does not hold).  ``mask`` is float 0/1, ``diag`` is A's
    diagonal.  Returns (best iterate (N, H, W), iterations run (N,) int32)."""
    if b.device.type == "cpu":
        return bini_cg_reference(b, x0, mask, diag, q_up, q_um, q_vp, q_vm, max_iter, tol)
    if b.device.type != "cuda":
        raise ValueError(f"bini_cg: no kernel for device {b.device}")
    fields = (b, x0, mask, diag, q_up, q_um, q_vp, q_vm)
    N, H, W = _check_fields("bini_cg", fields)
    plan = cg_plan(H, W)
    lib = _lib_cg()
    _check_schedulable(b.device.index, H, W, plan)
    out = torch.empty_like(b)
    iters = torch.empty(N, dtype=torch.int32, device=b.device)
    with torch.cuda.device(b.device):
        err = lib.bini_cg_launch(
            *(t.data_ptr() for t in fields), out.data_ptr(), iters.data_ptr(),
            N, H, W, int(max_iter), float(tol), plan.cluster, plan.threads, _stream(b),
        )
    if err:
        raise RuntimeError(f"bini_cg: kernel launch failed with CUDA error {err}")
    launch_counts["bini_cg"] += 1
    return out, iters
