"""Per-stage wall-clock timing that waits for the card.

Port of ``super_primitive_tpu/utils/timing.py`` (``StageTimer``).  A stage
ends with ``torch.cuda.synchronize()`` when the card is in use, so the time
of asynchronously launched kernels lands in the stage that launched them
and not in a later one that happens to wait.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates per-stage wall-clock time; ``device`` is where the
    stages' work runs (a CUDA device is synchronised at each stage end)."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.last[name] = dt

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'calls':>7}{'mean ms':>10}{'total s':>10}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<24}{s['count']:>7}{s['mean_ms']:>10.2f}{s['total_s']:>10.3f}"
            )
        return "\n".join(lines)
