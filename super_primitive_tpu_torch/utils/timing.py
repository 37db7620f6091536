"""Per-stage wall-clock timing that waits for the card, and a count of the
host's reads of device values.

Port of ``super_primitive_tpu/utils/timing.py`` (``StageTimer``).  A stage
ends with ``torch.cuda.synchronize()`` when the card is in use, so the time
of asynchronously launched kernels lands in the stage that launched them
and not in a later one that happens to wait.

Code that must read a device value on the host (a solver's stop test, a
step's packed result) reads it through :func:`to_host` or
:func:`host_flag`, which count each read; a stage records the reads made
inside it in ``StageTimer.syncs``.  A read waits for the device, so the
count is the number of host-device round trips a stage makes beside the
timer's own synchronisation at its end.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

_host_reads = 0


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (one counted read) that shares no memory with
    it."""
    global _host_reads
    _host_reads += 1
    return t.detach().cpu().numpy().copy()


def host_flag(t: torch.Tensor) -> bool:
    """A device boolean read on the host (one counted read)."""
    global _host_reads
    _host_reads += 1
    return bool(t)


class StageTimer:
    """Accumulates per-stage wall-clock time and host reads; ``device`` is
    where the stages' work runs (a CUDA device is synchronised at each stage
    end)."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.syncs: dict[str, int] = defaultdict(int)
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        reads0 = _host_reads
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.syncs[name] += _host_reads - reads0
        self.last[name] = dt

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000 * self.totals[name] / max(self.counts[name], 1),
                "host_reads": self.syncs[name],
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'calls':>7}{'mean ms':>10}{'total s':>10}{'reads':>8}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<24}{s['count']:>7}{s['mean_ms']:>10.2f}{s['total_s']:>10.3f}"
                f"{s['host_reads']:>8}"
            )
        return "\n".join(lines)
