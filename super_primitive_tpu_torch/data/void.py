"""VOID depth-completion dataset.

Port of ``super_primitive_tpu/data/void.py``.  Layout: ``<root>/
test_image.txt`` lists image paths relative to the root; the sparse depth,
validity map and ground truth sit in sibling directories (``image`` in the
path replaced by ``sparse_depth``, ``validity_map``, ``ground_truth``),
depths as 16-bit PNGs at 1/256 m; ``K.txt`` two directories above each
image.  Ground truth outside 0.2 < gt < 5.0 m is masked out and set to
``inf``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .image_io import read_png, read_rgb

MIN_DEPTH, MAX_DEPTH = 0.2, 5.0


def _depth_png(path: str, scale: float) -> np.ndarray:
    d = read_png(path).astype(np.float32) * scale
    d[d <= 0] = 0.0
    return d


class VoidDataset:
    def __init__(self, root_dir: str, split_file: str = "test_image.txt"):
        self.root = Path(root_dir)
        with open(self.root / split_file) as f:
            self.image_files = [line.rstrip() for line in f]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx):
        image_fp = str(self.root / self.image_files[idx])
        image = read_rgb(image_fp)
        K = np.loadtxt(Path(image_fp).parent.parent / "K.txt")
        sparse = _depth_png(image_fp.replace("image", "sparse_depth"), 1.0 / 256.0)
        validity = read_png(image_fp.replace("image", "validity_map")).astype(np.float32)
        validity[validity > 0] = 1.0
        gt = _depth_png(image_fp.replace("image", "ground_truth"), 1.0 / 256.0)
        mask = (gt < MAX_DEPTH) & (gt > MIN_DEPTH)
        gt[~mask] = np.inf
        return {
            "image": image,
            "sparse_depth": sparse,
            "validity_map": validity,
            "gt_depth": gt,
            "gt_valid": mask,
            "intrinsics": K,
        }
