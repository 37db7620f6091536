"""Fixed-capacity keyframe window buffers.

Port of ``super_primitive_tpu/odometry/window.py``.  The window keeps W
keyframe slots (image, intrinsics, pose, per-segment scalars, point bundle
padded to a shared capacity P) and S supporting-frame slots per keyframe
(image, pose, affine) as stacked tensors on the device, with validity masks
instead of list lengths.  Host bookkeeping (which slot holds which
timestamp) stays in the odometry loop.

Unlike the JAX package's immutable pytree, :class:`WindowBuffers` is a
dataclass of tensors updated in place; the odometry loop keeps no cache keyed on
the buffers' identity.  The per-slot point counts ``num_valid`` live on the
host, and :meth:`WindowBuffers.bundle_at` trims each bundle to exactly its
``num_valid`` rows: bundles are front-compacted and every consumer masks by
validity and normalises by ``num_valid``, so any trim at or above it is
exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cost import photometric as ph
from ..keyframe import PointBundle


@dataclasses.dataclass
class WindowBuffers:
    """Stacked device state for up to W keyframes with S supp slots each."""

    # keyframes
    images: torch.Tensor          # (W, H, Wd, C)
    K: torch.Tensor               # (W, 3, 3) geometry intrinsics
    poses: torch.Tensor           # (W, 4, 4) world-from-camera
    kp_logdepth: torch.Tensor     # (W, N)
    affine: torch.Tensor          # (W, 2)
    kf_valid: torch.Tensor        # (W,) bool
    # bundles (per keyframe)
    uv: torch.Tensor              # (W, P, 2)
    seg_id: torch.Tensor          # (W, P) int64
    base_logdepth: torch.Tensor   # (W, P)
    point_valid: torch.Tensor     # (W, P) bool
    num_valid: np.ndarray         # (W,) int64, on the host
    kp_base: torch.Tensor         # (W, N)
    # supporting frames
    supp_images: torch.Tensor     # (W, S, H, Wd, C)
    supp_poses: torch.Tensor      # (W, S, 4, 4)
    supp_affine: torch.Tensor     # (W, S, 2)
    supp_valid: torch.Tensor      # (W, S) bool

    # an unsharded window: no mesh, nothing to reduce over
    # (``parallel.mesh.ShardedWindow`` splits the bundle points over sp)
    mesh = None

    @property
    def group(self):
        return None

    @property
    def capacity(self) -> int:
        return self.images.shape[0]

    @property
    def supp_capacity(self) -> int:
        return self.supp_images.shape[1]

    # unified pools: W keyframe entries then the W*S supp slots flattened;
    # the index convention of mapper.build_slots / build_masks
    def image_pool(self) -> torch.Tensor:
        W, S = self.capacity, self.supp_capacity
        return torch.cat([self.images, self.supp_images.reshape((W * S,) + self.images.shape[1:])])

    def pose_pool(self) -> torch.Tensor:
        W, S = self.capacity, self.supp_capacity
        return torch.cat([self.poses, self.supp_poses.reshape(W * S, 4, 4)])

    def affine_pool(self) -> torch.Tensor:
        W, S = self.capacity, self.supp_capacity
        return torch.cat([self.affine, self.supp_affine.reshape(W * S, 2)])

    def bundle_at(self, i: int) -> PointBundle:
        """Slot ``i``'s point bundle, trimmed to its ``num_valid`` rows."""
        n = int(self.num_valid[i])
        return PointBundle(
            uv=self.uv[i, :n], seg_id=self.seg_id[i, :n],
            base_logdepth=self.base_logdepth[i, :n],
            valid=self.point_valid[i, :n], num_valid=n,
        )

    def source_samples(self, i: int, geo_dims) -> ph.SourceSamples:
        """Slot ``i``'s image sampled at its bundle pixels."""
        return ph.precompute_source(self.images[i], self.bundle_at(i), geo_dims)


@dataclasses.dataclass
class HostKeyFrame:
    """Host-side per-keyframe record (the reference's pickled dict plus the
    geometry maps needed for depth re-initialisation)."""

    timestamp: str
    image: np.ndarray                  # (H, W, C) float32
    K: np.ndarray
    regions: np.ndarray                # (N_i, H, W) bool (actual count)
    logdepth_perseg: np.ndarray        # (N_i, H, W)
    keypoints_rc: np.ndarray           # (N_i, 2) int pixel (row, col)
    pose: np.ndarray                   # (4, 4)
    kp_logdepth: np.ndarray            # (N_i,)
    affine: np.ndarray                 # (2,)


def empty_window(window_size: int, supp_cap: int, img_hw: tuple[int, int],
                 channels: int, seg_cap: int, point_cap: int,
                 device: str | torch.device = "cuda") -> WindowBuffers:
    H, Wd = img_hw
    W, S, N, P = window_size, supp_cap, seg_cap, point_cap

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def eye(n, *lead):
        return torch.eye(n, device=device).repeat(*lead, 1, 1)

    return WindowBuffers(
        images=zeros(W, H, Wd, channels), K=eye(3, W), poses=eye(4, W),
        kp_logdepth=zeros(W, N), affine=zeros(W, 2), kf_valid=zeros(W, dtype=torch.bool),
        uv=zeros(W, P, 2), seg_id=zeros(W, P, dtype=torch.int64),
        base_logdepth=zeros(W, P), point_valid=zeros(W, P, dtype=torch.bool),
        num_valid=np.zeros(W, np.int64), kp_base=zeros(W, N),
        supp_images=zeros(W, S, H, Wd, channels), supp_poses=eye(4, W, S),
        supp_affine=zeros(W, S, 2), supp_valid=zeros(W, S, dtype=torch.bool),
    )


def set_keyframe_slot(buffers: WindowBuffers, slot: int, image: np.ndarray,
                      K: np.ndarray, pose: np.ndarray, kp_logdepth: np.ndarray,
                      affine: np.ndarray, bundle: PointBundle,
                      kp_base: np.ndarray) -> None:
    """Write one keyframe into ``slot`` (in place).  Per-segment arrays are
    padded to the window's segment capacity; ``bundle`` is padded to its
    point capacity."""
    N = buffers.kp_logdepth.shape[1]
    n = kp_logdepth.shape[0]
    if n > N:
        raise ValueError(f"segment cap {N} < {n}")
    if bundle.capacity != buffers.uv.shape[1]:
        raise ValueError(f"bundle capacity {bundle.capacity} != window {buffers.uv.shape[1]}")
    dev = buffers.images.device

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    buffers.images[slot] = t(image)
    buffers.K[slot] = t(K)
    buffers.poses[slot] = t(pose)
    buffers.kp_logdepth[slot] = 0.0
    buffers.kp_logdepth[slot, :n] = t(kp_logdepth)
    buffers.affine[slot] = t(affine)
    buffers.kf_valid[slot] = True
    buffers.uv[slot] = bundle.uv
    buffers.seg_id[slot] = bundle.seg_id
    buffers.base_logdepth[slot] = bundle.base_logdepth
    buffers.point_valid[slot] = bundle.valid
    buffers.num_valid[slot] = bundle.num_valid
    buffers.kp_base[slot] = 0.0
    buffers.kp_base[slot, :n] = t(kp_base)
    buffers.supp_valid[slot] = False


def roll_window(buffers: WindowBuffers) -> None:
    """Evict slot 0 (the reference's pop_kf(0)): shift every slot left in
    place; the last slot becomes empty and invalid."""
    for f in dataclasses.fields(buffers):
        x = getattr(buffers, f.name)
        if isinstance(x, np.ndarray):
            setattr(buffers, f.name, np.concatenate([x[1:], np.zeros_like(x[:1])]))
        else:
            setattr(buffers, f.name, torch.cat([x[1:], torch.zeros_like(x[:1])]))


def set_supporting_slot(buffers: WindowBuffers, kf_slot: int, supp_slot: int,
                        image: torch.Tensor, pose: np.ndarray, affine: np.ndarray) -> None:
    dev = buffers.images.device
    buffers.supp_images[kf_slot, supp_slot] = image
    buffers.supp_poses[kf_slot, supp_slot] = torch.tensor(np.asarray(pose, np.float32), device=dev)
    buffers.supp_affine[kf_slot, supp_slot] = torch.tensor(np.asarray(affine, np.float32),
                                                           device=dev)
    buffers.supp_valid[kf_slot, supp_slot] = True


def clear_supporting(buffers: WindowBuffers, kf_slot: int | None = None) -> None:
    if kf_slot is None:
        buffers.supp_valid[:] = False
    else:
        buffers.supp_valid[kf_slot] = False
