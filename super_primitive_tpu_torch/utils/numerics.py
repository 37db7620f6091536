"""Float32 operations with the JAX package's rounding."""

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
