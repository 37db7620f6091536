"""TUM RGB-D dataset loaders.

Port of ``super_primitive_tpu/data/tum.py``: ``associations.txt`` pairs
each RGB frame with its depth frame; depth is divided by 5000 and clipped
at 10 m; the pose is the ground-truth line nearest in time.  Frames come
out as dicts: ``image`` (H, W, 3) RGB uint8, ``depth`` float32 metres,
``T`` (4, 4) world-from-camera (None without a trajectory file),
``intrinsics`` (3, 3) and ``timestamp``.  By default the images are
decoded by the prefetching native loader (``native_loader``: C++ threads,
and for ``tum_undistort`` the undistort on those threads too), as the JAX
package's loaders do; ``native=False`` decodes with the numpy reader
``image_io`` on the caller's thread instead.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation

from .image_io import png_size, read_png, read_rgb
from .transforms import scale_and_filter_depth
from .undistort import remap_bilinear, undistort_maps

DEPTH_SCALE = 1.0 / 5000.0
MAX_DEPTH = 10.0

# default (fr2 and later) intrinsics
K_DEFAULT = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]], np.float64)

# fr1 intrinsics and distortion, and the border cropped after undistortion
K_FR1 = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float64)
DIST_FR1 = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
CROP_W, CROP_H = 32, 16


def load_groundtruth(traj_file: str) -> np.ndarray:
    """(n, 8) rows (t, tx, ty, tz, qx, qy, qz, qw), '#' lines skipped."""
    with open(traj_file) as f:
        lines = [line for line in f if not line.startswith("#")]
    return np.loadtxt(lines, delimiter=" ")


def pose_at_timestamp(t_poses: np.ndarray, timestamp: float) -> np.ndarray:
    """The 4x4 pose of the ground-truth line nearest ``timestamp``."""
    idx = int(np.abs(timestamp - t_poses[:, 0]).argmin())
    T = np.eye(4)
    T[:3, :3] = Rotation.from_quat(t_poses[idx, 4:8]).as_matrix()
    T[:3, 3] = t_poses[idx, 1:4]
    return T


class TUMDataset:
    """Plain TUM loader.  ``intrinsics`` (fx, fy, cx, cy) overrides the
    default K; ``native`` picks the native loader (the default) or
    ``image_io``."""

    def __init__(self, root_dir: str, traj_file: Optional[str] = None, intrinsics=None,
                 native: bool = True):
        self.root_dir = root_dir
        self.t_poses = load_groundtruth(traj_file) if traj_file else None
        if intrinsics is not None:
            fx, fy, cx, cy = intrinsics
            self.intrinsics = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        else:
            self.intrinsics = K_DEFAULT.copy()
        with open(os.path.join(root_dir, "associations.txt")) as f:
            rows = [line.rstrip().split() for line in f]
        self.timestamps = np.array([float(r[0]) for r in rows])
        self.rgb_files = [r[1] for r in rows]
        self.depth_files = [r[3] for r in rows]
        self._rgb_loader = self._depth_loader = None
        if native:
            from .native_loader import NativeImageLoader

            self._rgb_loader = NativeImageLoader(
                [os.path.join(root_dir, f) for f in self.rgb_files])
            self._depth_loader = NativeImageLoader(
                [os.path.join(root_dir, f) for f in self.depth_files])

    def __len__(self):
        return len(self.rgb_files)

    def _read_pair(self, idx):
        """(image RGB uint8, raw 16-bit depth)."""
        if self._rgb_loader is not None:
            return self._rgb_loader.rgb(idx), self._depth_loader[idx]
        image = read_rgb(os.path.join(self.root_dir, self.rgb_files[idx]))
        depth = read_png(os.path.join(self.root_dir, self.depth_files[idx]))
        return image, depth

    def _frame(self, idx, image, depth) -> dict:
        T = (pose_at_timestamp(self.t_poses, self.timestamps[idx])
             if self.t_poses is not None else None)
        return {
            "image": image,
            "depth": scale_and_filter_depth(depth, DEPTH_SCALE, MAX_DEPTH),
            "T": T,
            "intrinsics": self.intrinsics,
            "timestamp": self.timestamps[idx],
        }

    def __getitem__(self, idx):
        return self._frame(idx, *self._read_pair(idx))


class TUMUndistortDataset(TUMDataset):
    """fr1 variant: the image undistorted with the fr1 coefficients, image
    and depth cropped by 32 / 16 pixels, the principal point shifted by the
    crop.  With the native loader the undistort runs on its decode threads
    for images of the first image's size (read from its PNG header)."""

    def __init__(self, root_dir: str, traj_file: Optional[str] = None, native: bool = True):
        super().__init__(root_dir, traj_file, native=native)
        self.intrinsics_full = K_FR1.copy()
        self.intrinsics = K_FR1.copy()
        self.intrinsics[0, 2] -= CROP_W
        self.intrinsics[1, 2] -= CROP_H
        self._maps: dict[tuple[int, int], tuple] = {}
        self._native_hw = None
        if self._rgb_loader is not None and len(self):
            self._native_hw = png_size(os.path.join(root_dir, self.rgb_files[0]))
            self._rgb_loader.set_undistort(*self._maps_for(self._native_hw))

    def _maps_for(self, hw):
        if hw not in self._maps:
            self._maps[hw] = undistort_maps(self.intrinsics_full, DIST_FR1, *hw)
        return self._maps[hw]

    def __getitem__(self, idx):
        image, depth = self._read_pair(idx)
        hw = image.shape[:2]
        if hw != self._native_hw:
            image = remap_bilinear(image, *self._maps_for(hw))
        image = image[CROP_H:-CROP_H, CROP_W:-CROP_W, :]
        depth = depth[CROP_H:-CROP_H, CROP_W:-CROP_W]
        return self._frame(idx, image, depth)
