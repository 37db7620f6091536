"""Image and depth transforms shared by the dataset loaders.

Port of ``super_primitive_tpu/data/transforms.py``: host numpy, the same
arithmetic.
"""

from __future__ import annotations

import numpy as np


def bgr_to_rgb(image: np.ndarray) -> np.ndarray:
    return image[..., ::-1].copy()


def scale_and_filter_depth(depth: np.ndarray, scale: float, max_depth: float) -> np.ndarray:
    """Raw depth to metres, and depth beyond ``max_depth`` set to 0 (the
    far clip)."""
    depth = depth.astype(np.float32) * scale
    depth[depth > max_depth] = 0.0
    return depth


def image_to_float(image_hwc_uint8: np.ndarray) -> np.ndarray:
    """HWC uint8 [0, 255] -> HWC float32 [0, 1]."""
    return image_hwc_uint8.astype(np.float32) / 255.0
