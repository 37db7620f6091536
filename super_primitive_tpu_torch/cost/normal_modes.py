"""Residual channel modes with normal channels.

Port of ``super_primitive_tpu/cost/normal_modes.py``.  With
``frontend.include_normals`` the image carries (nx, ny, nz[, kappa]) after
its colour channels, and ``photometric_cost(mode=...)`` splits the pixels
by mode: the affine (colour) channels enter the residual; the normal
channels are rotated into the target frame, and their cosine term, like
the reference's, is zero.

Channels-last layout: pixels are (..., P, C) with C = 3 / 6 / 7 / 4 by mode.
"""

from __future__ import annotations

import torch

MODES = ("colour", "colour_norm", "colour_norm_kappa", "norm_kappa")


def split_by_mode(pixels: torch.Tensor, mode: str = "colour"):
    """(affine channels, cosine channels, kappa), None where a mode has none."""
    if mode == "colour":
        return pixels[..., :3], None, None
    if mode == "colour_norm":
        return pixels[..., :3], pixels[..., 3:6], None
    if mode == "colour_norm_kappa":
        return pixels[..., :3], pixels[..., 3:6], pixels[..., 6:7]
    if mode == "norm_kappa":
        return None, pixels[..., :3], pixels[..., 3:4]
    raise ValueError(f"unknown mode {mode!r}")


def transform_normals(pixels: torch.Tensor, pose: torch.Tensor, mode: str = "colour"):
    """The normal channels rotated by the pose's rotation (no gradient
    through it); the pixels themselves for ``mode='colour'``.  ``pose`` may
    carry leading batch dims that broadcast against the points axis."""
    if mode == "colour":
        return pixels
    _, normals, _ = split_by_mode(pixels, mode)
    R = pose[..., :3, :3].detach()
    rotated = torch.einsum("...ij,...pj->...pi", R, normals)
    if mode == "colour_norm":
        return torch.cat([pixels[..., :3], rotated], dim=-1)
    if mode == "colour_norm_kappa":
        return torch.cat([pixels[..., :3], rotated, pixels[..., 6:7]], dim=-1)
    return torch.cat([rotated, pixels[..., 3:4]], dim=-1)
