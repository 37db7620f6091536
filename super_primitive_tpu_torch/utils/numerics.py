"""Float32 operations with the JAX package's rounding, and the switch that
keeps float32 matmuls out of TF32."""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's vectorised CPU float32 sqrt can be off by one ulp; XLA's and
    CUDA's are correctly rounded.  Where a sqrt feeds a threshold or a
    comparison with the JAX package, take it in float64 and round once: a
    float64 square root of a float32 input rounds to the correctly rounded
    float32 result."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def einsum64(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of float32 operands accumulated in float64 (a float64
    result: round it once, after any reduction over devices).

    A float32 contraction over many points (the normal equations' sums over
    every point and channel) is summed in whatever order the device's BLAS
    picks: torch's CPU sgemm sums such a long, narrow contraction almost in
    sequence, 8e-6 relative on the GN track's 8x8 JtJ where XLA's reads
    5e-7, and an ill-conditioned solve turns that into a different step.
    In float64 the order no longer shows once the sum is rounded to float32:
    every host, device and shard layout gives the float64 sum's rounding."""
    return torch.einsum(spec, *(x.to(torch.float64) for x in operands))


def float32_matmuls() -> None:
    """Keep float32 matmuls and convolutions in float32 on every device:
    TF32 off for cuBLAS and cuDNN.  The geometry, the GN normal equations
    and the nets' float32 paths are held to the JAX package's float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def settle_cpu_exp() -> None:
    """Make the process's first CPU ``torch.exp`` a one-thread call.

    With torch 2.13's CPU build (MKL, 8 OpenMP threads), the first float32
    or float64 ``torch.exp`` of a process that is split over threads gave,
    in about one run in six, whole threads' chunks off by up to 1.5e-4
    relative; later calls, and a first call that one thread runs, were
    exact.  One exp of a one-element tensor settles it before any large
    call."""
    torch.exp(torch.zeros(1))
