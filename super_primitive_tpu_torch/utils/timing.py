"""Spans and counters of the port's work, and a sampler of the host's
resident memory.

Port of ``super_primitive_tpu/utils/timing.py`` (``StageTimer``), with
counters and profiler ranges beside it and ``RSSSampler``.

- :func:`span` opens a stage of an optional :class:`StageTimer` and, while
  a ``torch.profiler`` records, a ``record_function`` range named
  ``stage:<name>``, so a profile names what the host was doing on the
  device trace's own clock.  A stage ends with ``torch.cuda.synchronize()``
  when the card is in use, so the time of asynchronously launched kernels
  lands in the stage that launched them and not in a later one that
  happens to wait.  Stages nest: each knows its parent and its self time.
- :func:`count` adds to a named counter (``host_reads``,
  ``prompts_decoded``, ``masks_kept``, ``segments``).  The program calls it
  through this module (``timing.count(...)``), so a wrapper set on the
  module attribute sees every call.  A stage records what each counter
  gained inside it.
- Code that must read a device value on the host reads it through
  :func:`to_host` or :func:`host_flag`, which count ``host_reads``; a
  stage's ``StageTimer.syncs`` is that count.  A read waits for the
  device, so it is a host-device round trip beside the timer's own
  synchronisation at a stage's end.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch

_NULL = contextlib.nullcontext()
# every counter's total in this process
_counters: dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counters[name] += n


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (one counted read) that shares no memory with
    it."""
    count("host_reads")
    out = t.detach().cpu().numpy()
    # .cpu() of a CPU tensor is the tensor itself; of a card's, a new buffer
    return out.copy() if t.device.type == "cpu" else out


def host_flag(t) -> bool:
    """A device boolean read on the host (one counted read); ``t`` may be
    the bool a reading call returned (``torch.equal``)."""
    count("host_reads")
    return bool(t)


def _range(name: str):
    """A profiler range ``stage:<name>`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"stage:{name}")
    return _NULL


def span(timer: "StageTimer | None", name: str):
    """Stage ``name`` of ``timer``; without a timer, only the profiler's
    range, and nothing while no profiler records."""
    return timer.stage(name) if timer is not None else _range(name)


class StageTimer:
    """Accumulates per-stage wall-clock time, host reads and counters;
    ``device`` is where the stages' work runs (a CUDA device is
    synchronised at each stage end).

    Per stage name: ``totals`` seconds, ``counts`` calls, ``last`` the last
    call's seconds, ``syncs`` host reads, ``parents`` the enclosing stage of
    its last call (None at the top), ``child_s`` the seconds of the stages
    directly inside it, ``counted`` {counter: gain}.  ``counters``: what
    each counter gained inside the outermost stages."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.syncs: dict[str, int] = defaultdict(int)
        self.last: dict[str, float] = {}
        self.parents: dict[str, str | None] = {}
        self.child_s: dict[str, float] = defaultdict(float)
        self.counted: dict[str, dict[str, int]] = defaultdict(dict)
        self.counters: dict[str, int] = defaultdict(int)
        self._open: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        with _range(name):
            parent = self._open[-1] if self._open else None
            before = dict(_counters)
            self._open.append(name)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._open.pop()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.last[name] = dt
        self.parents[name] = parent
        if parent is not None:
            self.child_s[parent] += dt
        gains = {k: v - before.get(k, 0) for k, v in _counters.items() if v != before.get(k, 0)}
        self.syncs[name] += gains.get("host_reads", 0)
        mine = self.counted[name]
        for k, v in gains.items():
            mine[k] = mine.get(k, 0) + v
            if parent is None:
                self.counters[k] += v

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000 * self.totals[name] / max(self.counts[name], 1),
                "host_reads": self.syncs[name],
                "parent": self.parents.get(name),
                "self_s": self.totals[name] - self.child_s.get(name, 0.0),
                "counters": dict(self.counted.get(name, {})),
            }
            for name in self.totals
        }

    def report(self) -> str:
        """One line a stage, each under its parent and indented by its
        depth."""
        s = self.summary()
        lines = [f"{'stage':<28}{'calls':>7}{'mean ms':>10}{'total s':>10}{'self s':>10}"
                 f"{'reads':>8}  counters"]

        def walk(name, depth):
            r = s[name]
            gains = " ".join(f"{k}={v}" for k, v in sorted(r["counters"].items())
                             if k != "host_reads")
            lines.append(f"{'  ' * depth + name:<28}{r['count']:>7}{r['mean_ms']:>10.2f}"
                         f"{r['total_s']:>10.3f}{r['self_s']:>10.3f}{r['host_reads']:>8}"
                         f"  {gains}".rstrip())
            for child in sorted(c for c in s if s[c]["parent"] == name):
                walk(child, depth + 1)

        for name in sorted(s):
            if s[name]["parent"] not in s:
                walk(name, 0)
        return "\n".join(lines)


RSS_INTERVAL_S = 0.01  # seconds between the RSS sampler's readings


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
