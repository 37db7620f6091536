"""Replica dataset loader.

Port of ``super_primitive_tpu/data/replica.py``: ``rgb/rgb_{i}.png``,
``depth/depth_{i}.png`` at 1/1000 m (clipped at 10 m) and the
world-from-camera poses of ``traj_w_c.txt``, 16 numbers a line.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .image_io import read_png, read_rgb
from .transforms import scale_and_filter_depth

DEPTH_SCALE = 1.0 / 1000.0
MAX_DEPTH = 10.0


def replica_K() -> np.ndarray:
    """The 1024x768 Replica render intrinsics."""
    return np.array([[886.81, 0, 512.0], [0, 886.81, 384.0], [0, 0, 1.0]], np.float64)


class ReplicaDataset:
    def __init__(self, root_dir: str, normal_dir: Optional[str] = None, intrinsics=None):
        self.root_dir = root_dir
        self.normal_dir = normal_dir
        if intrinsics is not None:
            fx, fy, cx, cy = intrinsics
            self._K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        else:
            self._K = replica_K()
        traj_file = os.path.join(root_dir, "traj_w_c.txt")
        self.Twc = np.loadtxt(traj_file, delimiter=" ").reshape([-1, 4, 4])

    def __len__(self):
        return self.Twc.shape[0]

    def __getitem__(self, idx):
        image = read_rgb(os.path.join(self.root_dir, f"rgb/rgb_{idx}.png"))
        depth = read_png(os.path.join(self.root_dir, f"depth/depth_{idx}.png")).astype(np.float32)
        normals, normals_mask = None, None
        if self.normal_dir is not None:
            normals, normals_mask = load_gt_normals(
                os.path.join(self.normal_dir, f"depth_{idx}_tblr_k3.png"))
        return {
            "image": image,
            "depth": scale_and_filter_depth(depth, DEPTH_SCALE, MAX_DEPTH),
            "T": self.Twc[idx],
            "normals": normals,
            "normals_mask": normals_mask,
            "intrinsics": self._K,
            "timestamp": float(idx),
        }


def load_gt_normals(normal_path: str):
    """A rendered ground-truth normal map: RGB PNG -> normals in [-1, 1],
    and the mask of pixels with any channel non-zero."""
    normal = read_rgb(normal_path)
    mask = np.sum(normal, axis=2, keepdims=True) > 0
    normal = (normal.astype(np.float32) / 255.0) * 2.0 - 1.0
    return normal, mask
