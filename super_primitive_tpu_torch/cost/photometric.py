"""Dense photometric reprojection cost over the fixed-shape PointBundle.

Port of ``super_primitive_tpu/cost/photometric.py``: the
single-target cost of tracking and two-frame SfM, and the batched cost of
mapping (one source keyframe against stacked targets).  Per point:

  1. spread each segment's scalar log-depth shift over its frozen per-point
     log-depths;
  2. exp -> depth; unproject bundle pixels with geometry K;
  3. transform into the target frame (pose = T_target_from_source);
  4. project with K, normalize by geometry dims, bilinear-sample the target
     pyramid image (normalized coords make the sampling resolution-free);
  5. optional affine brightness compensation
     exp(-(a_t - a_s)) * rgb + (b_t - b_s);
  6. masked L1, mean over channels x region points (padding excluded).

Source samples are pose/depth independent and computed once per level.

The gradient of the per-segment spread is a segment sum.  The JAX package
takes it as a fixed-order one-hot contraction; here it is the backward of
an index gather, which on CUDA sums with atomics in no fixed order.  Runs on
the card therefore agree with the CPU and with the JAX package to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..geometry import projection
from ..keyframe import PointBundle
from ..ops.sampling import bilinear_sample, bilinear_sample_packed
from .normal_modes import split_by_mode, transform_normals

# The reference uses z > 1e-7 in the single-target path and z > 1e-6 in
# the batched path.
Z_VALID_SINGLE = 1e-7
Z_VALID_BATCH = 1e-6


class SourceSamples(NamedTuple):
    """Per-level precomputed source-image samples."""

    pixels: torch.Tensor   # (P, C)
    valid: torch.Tensor    # (P,) bool: |coord| <= 0.99 & bundle validity


def spread_logdepth(
    bundle: PointBundle, kp_logdepth: torch.Tensor, kp_base_logdepth: torch.Tensor
) -> torch.Tensor:
    """Per-point log-depth from per-segment scalars:
    base + (kp_logdepth - kp_base_logdepth)[seg]."""
    shift = kp_logdepth - kp_base_logdepth
    return bundle.base_logdepth + shift[bundle.seg_id]


def normalized_image_coords(uv: torch.Tensor, geo_dims: tuple[int, int]) -> torch.Tensor:
    """(u, v) pixel coords at geometry resolution -> [-1, 1] normalized
    (x, y), align_corners=True over (W, H)."""
    return 2.0 * uv / _coord_dims(tuple(geo_dims), uv.device) - 1.0


@functools.lru_cache(maxsize=None)
def _coord_dims(geo_dims: tuple[int, int], device: torch.device) -> torch.Tensor:
    """(W - 1, H - 1) as float32 on ``device``, built once: a tensor built
    from host values on each call would copy it and wait for the card."""
    H, W = geo_dims
    return torch.tensor([W - 1, H - 1], dtype=torch.float32, device=device)


def precompute_source(
    image: torch.Tensor, bundle: PointBundle, geo_dims: tuple[int, int]
) -> SourceSamples:
    """Sample the source pyramid image at bundle pixels."""
    coords = normalized_image_coords(bundle.uv, geo_dims)
    pixels, valid = bilinear_sample(image, coords)
    return SourceSamples(pixels=pixels, valid=valid & bundle.valid)


def affine_compensate(trg_pixels: torch.Tensor, src_affine: torch.Tensor,
                      trg_affine: torch.Tensor) -> torch.Tensor:
    """Affine brightness model on the RGB channels:
    rgb' = exp(-(a_t - a_s)) * rgb + (b_t - b_s).  Leading batch dims of the
    affine parameters broadcast over points."""
    a = (trg_affine[..., 0] - src_affine[..., 0])[..., None, None]
    b = (trg_affine[..., 1] - src_affine[..., 1])[..., None, None]
    rgb = torch.exp(-a) * trg_pixels[..., :3] + b
    return torch.cat([rgb, trg_pixels[..., 3:]], dim=-1)


def photometric_cost_batch(
    bundle: PointBundle,
    src: SourceSamples,
    trg_packed: torch.Tensor,
    K: torch.Tensor,
    geo_dims: tuple[int, int],
    kp_logdepth: torch.Tensor,
    kp_base_logdepth: torch.Tensor,
    poses: torch.Tensor,
    affine: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One source keyframe against B stacked targets: ``trg_packed`` (B, H,
    W, 4C) packed target images, ``poses`` (B, 4, 4) T_target_from_source,
    ``affine`` (source (2,), targets (B, 2)) or None.  Returns per-target
    residuals (B,)."""
    logd = spread_logdepth(bundle, kp_logdepth, kp_base_logdepth)
    pts = projection.unproject(bundle.uv, torch.exp(logd), K)
    pts_t = projection.transform(pts[None], poses)                 # (B, P, 3)
    coords = normalized_image_coords(projection.project(pts_t, K), geo_dims)
    trg_pixels, trg_valid = bilinear_sample_packed(trg_packed, coords)
    trg_valid = trg_valid & (pts_t[..., 2].detach() > Z_VALID_BATCH)
    if affine is not None:
        trg_pixels = affine_compensate(trg_pixels, affine[0], affine[1])
    full_mask = (src.valid & trg_valid).to(trg_pixels.dtype)
    diff = torch.abs((src.pixels[..., :3] - trg_pixels[..., :3]) * full_mask[..., None])
    return torch.sum(diff, dim=(-2, -1)) / (3 * max(bundle.num_valid, 1))


def photometric_cost(
    bundle: PointBundle,
    src: SourceSamples,
    trg_packed: torch.Tensor,
    K: torch.Tensor,
    geo_dims: tuple[int, int],
    kp_logdepth: torch.Tensor,
    kp_base_logdepth: torch.Tensor,
    pose: torch.Tensor,
    affine: tuple[torch.Tensor, torch.Tensor] | None = None,
    mode: str = "colour",
) -> torch.Tensor:
    """Single-target photometric cost, a scalar (mean over channels x region
    points).  ``trg_packed`` is the target image after
    :func:`pack_bilinear_taps` (hoisted out of the optimizer loop by the
    caller); ``pose`` is T_target_from_source (4, 4); ``affine`` is
    (source, target) brightness parameters or None.  ``mode`` splits
    images with normal channels appended (``normal_modes``): the residual
    takes the affine channels only, and is zero for ``"norm_kappa"``, which
    has none (the reference leaves the cosine term at zero)."""
    logd = spread_logdepth(bundle, kp_logdepth, kp_base_logdepth)
    z = torch.exp(logd)
    pts = projection.unproject(bundle.uv, z, K)
    pts_t = projection.transform(pts, pose)

    uv_t = projection.project(pts_t, K)
    coords = normalized_image_coords(uv_t, geo_dims)
    trg_pixels, trg_valid = bilinear_sample_packed(trg_packed, coords)
    trg_valid = trg_valid & (pts_t[..., 2].detach() > Z_VALID_SINGLE)
    if affine is not None:
        trg_pixels = affine_compensate(trg_pixels, affine[0], affine[1])

    if mode == "colour":
        # the RGB channels only, even when normals are appended
        src_pixels = src.pixels[..., :3]
        trg_pixels = trg_pixels[..., :3]
    else:
        src_pixels = split_by_mode(transform_normals(src.pixels, pose, mode), mode)[0]
        if src_pixels is None:
            return torch.zeros((), dtype=trg_pixels.dtype, device=trg_pixels.device)
        trg_pixels = split_by_mode(trg_pixels, mode)[0]
    full_mask = (src.valid & trg_valid).to(trg_pixels.dtype)
    C = src_pixels.shape[-1]
    diff = torch.abs((src_pixels - trg_pixels) * full_mask[..., None])
    return torch.sum(diff) / (C * max(bundle.num_valid, 1))

