"""Hole filling for completed depth.

Port of ``super_primitive_tpu/depth_completion/fill_in.py``: scipy
``griddata`` (linear) over the valid pixels, then the nearest valid value
(Euclidean distance transform) for what lies outside their convex hull.
Host numpy and scipy.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as nd
from scipy.interpolate import griddata


def fill_depth_nearest(depth: np.ndarray, invalid_mask: np.ndarray) -> np.ndarray:
    ind = nd.distance_transform_edt(invalid_mask, return_distances=False, return_indices=True)
    return depth[tuple(ind)]


def fill_single_griddata(depths: np.ndarray, invalid: np.ndarray) -> np.ndarray:
    """(H, W) float64 depth with the ``invalid`` pixels interpolated."""
    depths = np.asarray(depths, np.float64).copy()
    depths[invalid] = np.nan
    x, y = np.indices(depths.shape)
    interp = depths.copy()
    known = ~np.isnan(depths)
    if known.sum() >= 4:
        interp[np.isnan(depths)] = griddata(
            (x[known], y[known]), depths[known], (x[np.isnan(depths)], y[np.isnan(depths)]))
    return fill_depth_nearest(interp, np.isnan(interp))
