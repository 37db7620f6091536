"""VOID depth-completion metrics.

Port of ``super_primitive_tpu/depth_completion/metrics.py``: RMSE, MAE and
AbsRel in mm, their inverse-depth variants in 1/km, the delta thresholds,
and a running averager; numpy, the same formulas.
"""

from __future__ import annotations

import numpy as np


def rmse(estimate, target):
    return np.sqrt(np.mean((estimate - target) ** 2))


def mae(estimate, target):
    return np.mean(np.abs(estimate - target))


def absrel(estimate, target):
    return np.mean(np.abs(estimate - target) / target)


def inv_rmse(estimate, target):
    return np.sqrt(np.mean((1.0 / estimate - 1.0 / target) ** 2))


def inv_mae(estimate, target):
    return np.mean(np.abs(1.0 / estimate - 1.0 / target))


def inv_absrel(estimate, target):
    return np.mean(np.abs(1.0 / estimate - 1.0 / target) / (1.0 / target))


def delta_metric(estimate, target, mult_a=False):
    """Threshold accuracies: the share of pixels with max(t/e, e/t) below
    1.05, 1.10, 1.25, 1.25² and 1.25³ (a0/a1 repeat a10/a25)."""
    thresh = np.maximum(target / estimate, estimate / target)
    a = {
        "a5": (thresh < 1.05).astype(np.float32).mean(),
        "a10": (thresh < 1.10).astype(np.float32).mean(),
        "a25": (thresh < 1.25).astype(np.float32).mean(),
        "a0": (thresh < 1.10).astype(np.float32).mean(),
        "a1": (thresh < 1.25).astype(np.float32).mean(),
        "a2": (thresh < 1.25**2).astype(np.float32).mean(),
        "a3": (thresh < 1.25**3).astype(np.float32).mean(),
    }
    if mult_a:
        a = {k: v * 100 for k, v in a.items()}
    return a


class ErrorMetrics:
    """Per-image metrics over the ``valid`` pixels: depth in mm, inverse
    depth in 1/km."""

    def __init__(self):
        self.rmse = self.mae = self.absrel = np.inf
        self.inv_rmse = self.inv_mae = self.inv_absrel = np.inf

    def compute(self, estimate, target, valid):
        e = estimate[valid]
        t = target[valid]
        self.rmse = rmse(1000.0 * e, 1000.0 * t)
        self.mae = mae(1000.0 * e, 1000.0 * t)
        self.absrel = absrel(1000.0 * e, 1000.0 * t)
        self.inv_rmse = inv_rmse(0.001 * e, 0.001 * t)
        self.inv_mae = inv_mae(0.001 * e, 0.001 * t)
        self.inv_absrel = inv_absrel(0.001 * e, 0.001 * t)


class ErrorMetricsAverager:
    _FIELDS = ("rmse", "mae", "absrel", "inv_rmse", "inv_mae", "inv_absrel")

    def __init__(self):
        for f in self._FIELDS:
            setattr(self, f + "_avg", 0.0)
        self.total_count = 0

    def accumulate(self, m: ErrorMetrics):
        for f in self._FIELDS:
            setattr(self, f + "_avg", getattr(self, f + "_avg") + getattr(m, f))
        self.total_count += 1

    def average(self):
        for f in self._FIELDS:
            setattr(self, f + "_avg", getattr(self, f + "_avg") / self.total_count)

    def as_dict(self):
        return {f: getattr(self, f + "_avg") for f in self._FIELDS}
