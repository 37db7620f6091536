"""The port's opt-in profiler trace (``utils.timing.profiler_trace``), the
counterpart of the JAX package's ``jax.profiler`` context: a no-op without
a directory, and on the CPU a Chrome trace of the enclosed work written
under the directory; and the host RSS sampler the full-size day-0 leg
reports with (``utils.timing.RSSSampler``)."""

import json
import time

import numpy as np
import torch

from super_primitive_tpu_torch.utils.timing import RSSSampler, profiler_trace


def test_profiler_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the profiler started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    for log_dir in (None, ""):
        with profiler_trace(log_dir):
            x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert list(tmp_path.iterdir()) == []


def test_profiler_trace_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with profiler_trace(str(log_dir)):
        torch.mm(torch.ones(32, 32), torch.ones(32, 32)).sum()
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_rss_sampler_sees_an_allocation():
    with RSSSampler() as rss:
        a = np.ones(64 * 2**20 // 8)  # 64 MiB, every page written
        # held until the sampler's thread has read it: on a loaded host the
        # thread can miss a fixed 50 ms window (it did in two 6-worker runs)
        deadline = time.monotonic() + 10.0
        while rss.peak - rss.start < 48 * 2**20 and time.monotonic() < deadline:
            time.sleep(0.01)
        del a
    assert rss.start > 0
    assert rss.peak - rss.start >= 48 * 2**20
