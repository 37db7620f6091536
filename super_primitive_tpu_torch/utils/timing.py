"""Per-stage wall-clock timing that waits for the card, and a count of the
host's reads of device values.

Port of ``super_primitive_tpu/utils/timing.py`` (``StageTimer``, and the
opt-in profiler trace ``profiler_trace``), with a sampler of the host's
resident memory (``RSSSampler``).  A stage
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
import os
import threading
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


RSS_INTERVAL_S = 0.01  # seconds between the RSS sampler's readings


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Opt-in ``torch.profiler`` trace of the enclosed work, written under
    ``log_dir`` as a Chrome trace (``*.pt.trace.json``: TensorBoard's
    profiler plugin, ``chrome://tracing`` or Perfetto read it); a no-op for
    a falsy ``log_dir``.  It records host activity, and the card's where
    CUDA is available."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield


class RSSSampler:
    """While open, a thread reads the process's resident set size from
    ``/proc/self/statm`` (Linux) every ``RSS_INTERVAL_S``: ``start`` is the
    reading on entry and ``peak`` the largest so far, in bytes (final once
    the block exits).  It covers only the span it is open, unlike
    ``ru_maxrss``, which a process inherits from the one that started it
    (the parent's high-water mark outlives fork and exec)."""

    def __init__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def read(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(RSS_INTERVAL_S):
            self.peak = max(self.peak, self.read())

    def __enter__(self) -> "RSSSampler":
        self.start = self.peak = self.read()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.read())
