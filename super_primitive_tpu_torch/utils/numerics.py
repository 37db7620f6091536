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


def float32_matmuls() -> None:
    """Keep float32 matmuls and convolutions in float32 on every device:
    TF32 off for cuBLAS and cuDNN.  The geometry, the GN normal equations
    and the nets' float32 paths are held to the JAX package's float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
