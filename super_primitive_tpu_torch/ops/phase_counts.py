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
translation of ``nets/sam/predictor._phase_upsample_counts``.  The counts
are integers and both versions form every interpolant in the same order, so
they agree exactly.  ``launch_counts["phase_counts"]`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MASK_THRESHOLD = 0.0

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


def _lib():
    lib = _build.library("phase_counts.cu")
    if not getattr(lib, "_typed", False):
        _I, _P = ctypes.c_int, ctypes.c_void_p
        lib.phase_counts_launch.argtypes = [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.phase_counts_launch.restype = _I
        lib._typed = True
    return lib


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
    if N * S * S >= 2**31 or not 1 <= s <= 16:
        raise ValueError(f"phase_counts: unsupported N={N}, S={S}, s={s}")
    counts = torch.empty((3, N), dtype=torch.int32, device=x.device)
    if N == 0:
        return counts[0], counts[1], counts[2]
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.phase_counts_launch(
            x.data_ptr(), N, S, int(s), int(input_hw[0]), int(input_hw[1]),
            counts[0].data_ptr(), counts[1].data_ptr(), counts[2].data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"phase_counts: kernel launch failed with CUDA error {err}")
    launch_counts["phase_counts"] += 1
    return counts[0], counts[1], counts[2]
