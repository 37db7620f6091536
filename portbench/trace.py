"""What the traced run reads: the program's stage spans, the launches of
the kernels that the cell's metrics ask for, and a ``torch.profiler`` trace
of a few frames.

- :func:`span_timer` is the program's ``utils.timing.StageTimer`` (each
  stage ends with a ``torch.cuda.synchronize``) with every stage also
  opened as a ``record_function`` range, so the trace can say which stage
  the host was in while the device sat idle.
- :class:`Launches` wraps, while it records, each function that a metric
  reader names in ``WRAPS`` ("module:function" of the program) and keeps
  what the reader's ``record(args, kwargs, out)`` takes from each call.
- :func:`read_trace` reduces the profiler's Chrome trace to the device's
  busy time, kernel times by name, device-to-host copies and the longest
  idle gaps named by the host's stage and operation.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict


def span_timer(device):
    """A ``StageTimer`` on ``device`` whose stages are also profiler
    ranges (``stage:<name>``)."""
    import torch
    from super_primitive_tpu_torch.utils.timing import StageTimer

    class SpanTimer(StageTimer):
        @contextlib.contextmanager
        def stage(self, name: str):
            with torch.profiler.record_function(f"stage:{name}"), super().stage(name):
                yield

    return SpanTimer(device)


class Launches:
    """While :attr:`on`, ``records[name]`` gathers ``readers[name].record``
    of every call of the function the reader wraps."""

    def __init__(self, readers: dict):
        self.on = False
        self.records = {name: [] for name, r in readers.items() if hasattr(r, "WRAPS")}
        self._orig = []
        for name in self.records:
            reader = readers[name]
            module_name, fn_name = reader.WRAPS.split(":")
            module = importlib.import_module(module_name)
            fn = getattr(module, fn_name)
            self._orig.append((module, fn_name, fn))
            setattr(module, fn_name, self._wrap(fn, reader.record, self.records[name]))

    def _wrap(self, fn, record, into):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on:
                into.append(record(args, kwargs, out))
            return out

        return wrapped

    def close(self):
        for module, fn_name, fn in reversed(self._orig):
            setattr(module, fn_name, fn)


def _union(intervals):
    """Merged [start, end) intervals of a list, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(events, t):
    """Name of the shortest event of ``events`` [(start, end, name)] that
    covers ``t``, or None."""
    best = None
    for s, e, name in events:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def _short(name: str, width: int = 120) -> str:
    """A kernel's name without its return type, cut to ``width``."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def read_trace(prof, frame_ranges: str = "portbench:frame") -> dict:
    """The device's side of a profile whose frames are ``record_function``
    ranges named ``frame_ranges``: ``window_s`` from the first frame's
    start to the last one's end, ``busy_s`` the union of kernel, copy and
    memset time in it, ``kernel_s`` {name: seconds}, ``dtoh`` the number of
    device-to-host copies, ``gaps`` the ten longest idle gaps [(stage/op,
    seconds)] and ``ops`` the ten device operations of most time."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    device, frames, stages, ops = [], [], [], []
    kernel_s = defaultdict(float)
    dtoh = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((s, e))
            kernel_s[name] += (e - s) * 1e-6
            dtoh += cat == "gpu_memcpy" and "DtoH" in name
        elif cat == "user_annotation" and name == frame_ranges:
            frames.append((s, e))
        elif cat == "user_annotation" and name.startswith("stage:"):
            stages.append((s, e, name[6:]))
        elif cat == "cpu_op":
            ops.append((s, e, name))
    if not frames or not device:
        return {}
    w0, w1 = min(s for s, _ in frames), max(e for _, e in frames)
    busy = _union([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for s, e in gaps[:10]:
        mid = 0.5 * (s + e)
        named.append([f"{_innermost(stages, mid) or 'no stage'}/{_innermost(ops, mid) or 'host'}",
                      (e - s) * 1e-6])
    top = [[_short(k), v] for k, v in
           sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "kernel_s": dict(kernel_s), "dtoh": dtoh, "frames": len(frames),
            "gaps": named, "ops": top}
