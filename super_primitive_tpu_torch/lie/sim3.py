"""Sim(3) operations in PyTorch.

Port of ``super_primitive_tpu/lie/sim3.py``: 4x4 matrices
[[s R, t], [0, 1]] with tangent ``xi = (omega[3], v[3], sigma)`` and scale
s = exp(sigma).  The exponential is the closed form t = W v with
W = C I + A Wx + B Wx^2 (Strasdat; Sophus sim3); every coefficient has a
series fallback, so values and gradients stay finite at theta -> 0 and
sigma -> 0.  All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

from . import so3

_EPS = 1e-6


def _w_coeffs(theta2: torch.Tensor, sigma: torch.Tensor):
    """(C, A, B) of W = C I + A Wx + B Wx^2."""
    one = torch.ones_like(theta2)
    small_t = theta2 < _EPS * _EPS
    small_s = torch.abs(sigma) < _EPS
    theta = torch.sqrt(torch.where(small_t, one, theta2))
    sigma_safe = torch.where(small_s, one, sigma)
    s = torch.exp(sigma)

    C = torch.where(small_s, 1.0 + 0.5 * sigma, (s - 1.0) / sigma_safe)

    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    c2 = theta2 + sigma * sigma
    c2_safe = torch.where(c2 < _EPS * _EPS, one, c2)
    theta2_safe = torch.where(small_t, one, theta2)

    # A: sigma ~ 0 -> (1 - cos)/theta^2 (or 1/2); else the mixed form
    A_s0 = torch.where(small_t, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2_safe)
    A_t0 = torch.where(small_s, 0.5 * one,
                       ((sigma_safe - 1.0) * s + 1.0) / (sigma_safe * sigma_safe))
    A_gen = (s * sin_t * sigma + (1.0 - s * cos_t) * theta) / (theta * c2_safe)
    A = torch.where(small_s, A_s0, torch.where(small_t, A_t0, A_gen))

    # B: sigma ~ 0 -> (theta - sin)/theta^3 (or 1/6); else the mixed form
    B_s0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - sin_t) / torch.where(small_t, one, theta2 * theta))
    B_t0 = torch.where(small_s, one / 6.0,
                       ((0.5 * sigma_safe ** 2 - sigma_safe + 1.0) * s - 1.0) / sigma_safe ** 3)
    B_gen = (C - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / c2_safe) / theta2_safe
    B = torch.where(small_s, B_s0, torch.where(small_t, B_t0, B_gen))
    return C, A, B


def _w_matrix(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    C, A, B = _w_coeffs(torch.sum(w * w, dim=-1), sigma)
    Wx = so3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wx.shape)
    return C[..., None, None] * eye + A[..., None, None] * Wx + B[..., None, None] * (Wx @ Wx)


def from_scale_rot_trans(s, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[[s R, t], [0, 1]] from scale(s) (...,), rotations (..., 3, 3) and
    translations (..., 3)."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = s[..., None, None] * R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential: (..., 7) [omega, v, sigma] -> (..., 4, 4)."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_w_matrix(w, sigma) @ v[..., None])[..., 0]
    return from_scale_rot_trans(torch.exp(sigma), so3.exp(w), t)


def scale_of(T: torch.Tensor) -> torch.Tensor:
    """The scale s of a Sim(3) matrix (det(sR) = s^3)."""
    d = torch.linalg.det(T[..., :3, :3])
    return torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)


def log(T: torch.Tensor) -> torch.Tensor:
    """Sim(3) logarithm: (..., 4, 4) -> (..., 7) [omega, v, sigma]."""
    s = scale_of(T)
    sigma = torch.log(s)
    w = so3.log(T[..., :3, :3] / s[..., None, None])
    v = torch.linalg.solve(_w_matrix(w, sigma), T[..., :3, 3:4])[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form Sim(3) inverse: [[R^T / s, -R^T t / s], [0, 1]]."""
    s = scale_of(T)
    R = T[..., :3, :3] / s[..., None, None]
    sR_inv = R.transpose(-2, -1) / s[..., None, None]
    t_inv = -(sR_inv @ T[..., :3, 3:4])[..., 0]
    return from_scale_rot_trans(torch.ones_like(s), sR_inv, t_inv)
