"""SAM mask statistics kernel K3 (phase counts), with its plain version.

Port of ``super_primitive_tpu/ops/pallas_phase_counts.py``: the Pallas TPU
kernel ``phase_counts_pallas`` becomes the CUDA C++ kernel
``csrc/phase_counts.cu``, built by ``_build`` at first use.

For N low-res logit slabs x (N, S, S) and an integer upsample factor s, it
counts over the s*s phases of the half-pixel bilinear x s upsample, without
materialising the upsampled grid, the pixels above +1, -1 and 0 inside the
unpadded region ``s*i + k < input_hw``: (hi, lo, area), each (N,) int32.

Dispatch is on the device of ``x``: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes :func:`phase_counts_reference`, the straight
translation of ``nets/sam/predictor._phase_upsample_counts``.  The two agree
exactly: the kernel forms the interpolants it forms in the reference's
order, and counts a pixel whose 3x3 window lies past a threshold's cutoffs
(:func:`phase_cutoffs`) without forming them, which gives the same counts.
:func:`launch_plan` picks the kernel's CTA shape from the input's shape.
``launch_counts["phase_counts"]`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

MASK_THRESHOLD = 0.0
# launch plan (an H100 sweep on the VO path's inputs): a CTA takes K3_BAND
# low-res rows, fewer (down to K3_MIN_BAND) where the launch would otherwise
# have under K3_MIN_CTAS CTAs, and two strips of rows for each four-column
# group of the region
K3_BAND = 16
K3_MIN_BAND = 4
K3_MIN_CTAS = 2 * 132

launch_counts = {"phase_counts": 0}


def reset_launch_counts() -> None:
    launch_counts["phase_counts"] = 0


def phase_counts_reference(x: torch.Tensor, s: int, input_hw: tuple[int, int]):
    """Plain version of K3: (hi, lo, area) (N,) int32 counts."""
    h_in, w_in = int(input_hw[0]), int(input_hw[1])
    S = x.shape[-1]
    xm_r = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    xp_r = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    idx = torch.arange(S, device=x.device)
    hi = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    lo = torch.zeros_like(hi)
    area = torch.zeros_like(hi)
    for ky in range(s):
        f = (ky + 0.5) / s - 0.5
        ry = (1 + f) * x - f * xm_r if f < 0 else (1 - f) * x + f * xp_r
        rym = torch.cat([ry[:, :, :1], ry[:, :, :-1]], dim=2)
        ryp = torch.cat([ry[:, :, 1:], ry[:, :, -1:]], dim=2)
        rok = (s * idx + ky) < h_in
        for kx in range(s):
            g = (kx + 0.5) / s - 0.5
            v = (1 + g) * ry - g * rym if g < 0 else (1 - g) * ry + g * ryp
            reg = rok[:, None] & ((s * idx + kx) < w_in)[None, :]
            hi += torch.sum((v > MASK_THRESHOLD + 1.0) & reg, dim=(1, 2), dtype=torch.int32)
            lo += torch.sum((v > MASK_THRESHOLD - 1.0) & reg, dim=(1, 2), dtype=torch.int32)
            area += torch.sum((v > MASK_THRESHOLD) & reg, dim=(1, 2), dtype=torch.int32)
    return hi, lo, area


# Dynamic shared memory a CTA may take (bytes): an H100 SM's 227 KB opt-in
# limit less 1 KB for the kernel's static arrays.
_MAX_DYN_SMEM = 227 * 1024 - 1024
# Float32 keys of the finite floats in order (see _key_floats).
_KEY_MIN, _KEY_MAX = -0x7F7FFFFF - 1, 0x7F7FFFFF
# the three thresholds in ascending order: the lo, area and hi counts
THRESHOLDS = (MASK_THRESHOLD - 1.0, MASK_THRESHOLD, MASK_THRESHOLD + 1.0)


def constant_interpolants(m: torch.Tensor, s: int) -> torch.Tensor:
    """(M,) float32 -> (M, s*s): every phase's interpolant of a pixel whose
    nine clamped neighbours all equal m, formed as the plain version forms
    it (same float32 weights, same order, no fused multiply-add)."""
    vs = []
    for ky in range(s):
        f = (ky + 0.5) / s - 0.5
        ry = (1 + f) * m - f * m if f < 0 else (1 - f) * m + f * m
        for kx in range(s):
            g = (kx + 0.5) / s - 0.5
            vs.append((1 + g) * ry - g * ry if g < 0 else (1 - g) * ry + g * ry)
    return torch.stack(vs, dim=-1)


def _key_floats(keys: np.ndarray) -> torch.Tensor:
    """Ordered int64 keys -> float32: key k >= 0 is the float with bits k,
    key -1 is -0.0 and key k < -1 the float with bits (-k - 1) | sign."""
    bits = np.where(keys >= 0, keys, (-keys - 1) | 0x80000000).astype(np.uint32)
    return torch.from_numpy(bits.view(np.float32).copy())


@functools.lru_cache(maxsize=None)
def phase_cutoffs(s: int) -> tuple[float, ...]:
    """(c_-1, c_0, c_+1, d_-1, d_0, d_+1) for the upsample factor s.

    c_t is the least float32 m whose constant window puts every phase above
    t, d_t the greatest whose constant window puts no phase above t.  Each
    interpolant is nondecreasing in each of its nine neighbours (the
    argument is in csrc/phase_counts.cu), so the kernel counts a pixel whose
    3x3 window has min >= c_t as above t in every phase, and one with
    max <= d_t as above t in none, without forming its interpolants.
    Found by bisection over the ordered finite floats, whose predicates are
    monotone in m for the same reason."""
    t = torch.tensor(THRESHOLDS, dtype=torch.float32)
    lo = np.full(6, _KEY_MIN, np.int64)  # c: P(lo) false; d: Q(lo) true
    hi = np.full(6, _KEY_MAX, np.int64)  # c: P(hi) true; d: Q(hi) false
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        v = constant_interpolants(_key_floats(mid), s)  # (6, s*s)
        above = (v > torch.cat([t, t])[:, None]).all(dim=1).numpy()
        none_above = (v <= torch.cat([t, t])[:, None]).all(dim=1).numpy()
        # c searches (0..2) move down where P holds; d searches (3..5) move up
        # where Q holds
        go_low = np.concatenate([above[:3], ~none_above[3:]])
        hi = np.where(go_low, mid, hi)
        lo = np.where(go_low, lo, mid)
    c = _key_floats(hi[:3]).tolist()
    d = _key_floats(lo[3:]).tolist()
    if not (c[0] <= c[1] <= c[2] and d[0] <= d[1] <= d[2]
            and all(dt < ct for ct, dt in zip(c, d))):
        raise AssertionError(f"phase_cutoffs({s}): cutoffs out of order: {c} {d}")
    return (*c, *d)


def region_lowres(S: int, s: int, input_hw: tuple[int, int]) -> tuple[int, int]:
    """(R, C): the low-res rows and columns with at least one phase inside
    the region, ceil(input_hw / s) clamped to [0, S]."""
    return tuple(min(max(-(-int(v) // s), 0), S) for v in input_hw)


def smem_bytes(S: int, band: int, C: int) -> int:
    """Dynamic shared memory of one CTA, passed to csrc/phase_counts.cu,
    which carves it in this order: the band with its two halo rows, the
    group queue (a band of the region's four-column groups), and the pixel
    queue, which takes the rest (here as many entries as the group queue)."""
    return ((band + 2) * S + 2 * band * -(-C // 4)) * 4


@functools.lru_cache(maxsize=None)
def launch_plan(N: int, S: int, s: int, input_hw: tuple[int, int]) -> tuple[int, int]:
    """(band, threads) of the kernel's launch: one CTA per slab and band of
    `band` low-res rows of the region, with two threads (strips of rows)
    for each four-column group.  A pure function of the shape; raises
    ValueError for a shape the kernel does not take."""
    if N < 1 or not 1 <= s <= 16 or not 1 <= S <= 0xFFFF or N * S * S >= 2**31:
        raise ValueError(f"phase_counts: unsupported N={N}, S={S}, s={s}")
    R, C = region_lowres(S, s, input_hw)
    threads = min(max(32 * -(-2 * -(-C // 4) // 32), 64), 512)
    band = K3_BAND
    while band > K3_MIN_BAND and N * -(-R // band) < K3_MIN_CTAS:
        band //= 2
    while band > 1 and smem_bytes(S, band, C) > _MAX_DYN_SMEM:
        band //= 2
    if smem_bytes(S, band, C) > _MAX_DYN_SMEM:
        raise ValueError(f"phase_counts: a {S}-wide slab does not fit a CTA's shared memory")
    return band, threads


def _lib():
    lib = _build.library("phase_counts.cu")
    if not getattr(lib, "_typed", False):
        _I, _P = ctypes.c_int, ctypes.c_void_p
        lib.phase_counts_launch.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
        lib.phase_counts_launch.restype = _I
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _cutoff_array(s: int):
    return (ctypes.c_float * 6)(*phase_cutoffs(s))


def phase_counts(x: torch.Tensor, s: int, input_hw: tuple[int, int]):
    """K3: (x (N, S, S) float32, s, input_hw (h, w) ints) -> (hi, lo, area),
    each (N,) int32."""
    if x.device.type == "cpu":
        return phase_counts_reference(x, s, input_hw)
    if x.device.type != "cuda":
        raise ValueError(f"phase_counts: no kernel for device {x.device}")
    if x.dim() != 3 or x.shape[1] != x.shape[2] or x.dtype != torch.float32:
        raise ValueError(f"phase_counts: x must be (N, S, S) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("phase_counts: x must be contiguous")
    N, S, _ = x.shape
    s, h_in, w_in = int(s), int(input_hw[0]), int(input_hw[1])
    if not 1 <= s <= 16:
        raise ValueError(f"phase_counts: unsupported s={s}")
    R, C = region_lowres(S, s, (h_in, w_in))
    if N == 0 or R == 0 or C == 0:
        counts = torch.zeros((3, N), dtype=torch.int32, device=x.device)
        return counts[0], counts[1], counts[2]
    band, threads = launch_plan(N, S, s, (h_in, w_in))
    counts = torch.empty((3, N), dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.phase_counts_launch(
            x.data_ptr(), N, S, s, h_in, w_in, band, threads, smem_bytes(S, band, C),
            _cutoff_array(s), counts.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"phase_counts: kernel launch failed with CUDA error {err}")
    launch_counts["phase_counts"] += 1
    return counts[0], counts[1], counts[2]
