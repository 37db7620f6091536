"""SO(3) operations in PyTorch.

Port of ``super_primitive_tpu/lie/so3.py``.  All functions broadcast over
leading batch dimensions.

Conventions:
  - rotation vectors ("omega") are axis-angle, shape (..., 3);
  - quaternions are stored (w, x, y, z) real-first.

Small-angle safety: every division by theta uses the double-``where`` trick
so both the value and the gradient are finite at theta -> 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle (..., 3) -> rotation matrix (..., 3, 3),
    with series expansions near zero so the map and its gradient are exact
    at the identity."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)

    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)

    W = hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A * W + B * WW


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), routed through the
    quaternion for robustness near pi."""
    return quat_to_rotvec(matrix_to_quat(R))


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion -> axis-angle, robust (value AND gradient) at
    small angles."""
    q = q * torch.sign(q[..., :1] + (q[..., :1] == 0).to(q.dtype))
    w, xyz = q[..., 0], q[..., 1:]
    n2 = torch.sum(xyz * xyz, dim=-1)
    small = n2 < _EPS
    n_safe = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    angle = 2.0 * torch.atan2(torch.where(small, torch.zeros_like(n_safe), n_safe), w)
    w_safe = torch.where(torch.abs(w) < _EPS, torch.ones_like(w), w)
    scale = torch.where(
        small, (2.0 / w_safe) * (1.0 - n2 / (3.0 * w_safe * w_safe)), angle / n_safe
    )
    return xyz * scale[..., None]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalizing quaternion (w, x, y, z) -> rotation matrix."""
    r, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z), best-conditioned branch,
    selected branchlessly with a one-hot."""
    batch = R.shape[:-2]
    m = R.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [m[..., i] for i in range(9)]

    q_abs2 = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    # grad-safe sqrt(max(x, 0)): the unselected branches must not produce
    # an infinite derivative at 0
    pos = q_abs2 > 1e-8
    q_abs = torch.where(
        pos, torch.sqrt(torch.where(pos, q_abs2, torch.ones_like(q_abs2))),
        torch.zeros_like(q_abs2),
    )

    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    # a clamp, not a maximum with a device constant: building that constant
    # would copy it from the host and wait for the card on every call
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))

    best = torch.argmax(q_abs, dim=-1)
    onehot = torch.nn.functional.one_hot(best, 4).to(R.dtype)
    return torch.sum(quat_candidates * onehot[..., None], dim=-2)


def renormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) via the quaternion round trip."""
    return quat_to_matrix(matrix_to_quat(R))
