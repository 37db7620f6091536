"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload tum_desk.keyframe --seed 7 --seconds 51 --trace 0

From the root of a checkout, on a machine with the cell's CUDA cards:

1. set-up: the cell's entry (``entries/<entry>.py``) makes its weights
   and inputs on the card and builds the program on them, a distinct view
   for each frame the window can hold (:data:`FRAMES_PER_S` a second) in
   an order drawn from ``--seed``; then :data:`WARMUP_FRAMES` frames on
   views of their own warm it up (the kernels build into the checkout's
   ``build/`` on a checkout's first run);
2. the window: one client calls the entry on frame after frame, each
   timed from its call to its result on the host, until ``--seconds``
   have passed; the frames the check samples (drawn from the seed) are
   observed on their way;
3. with ``--trace 1`` the window's first half runs as above and gives the
   model's share of the peak, its second half runs under the program's
   stage timer and gives the stage spans, then a ``torch.profiler`` trace
   of :data:`TRACE_FRAMES` more frames; the per-layer metrics;
4. the comparison with the plain reference (the entry's ``compare``).

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end ones, or with ``--trace 1`` the
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are
the last lines of standard error.  The run exits non-zero and prints no
result without the cards the cell asks for, and when JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    __package__ = "portbench"

import numpy as np  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "super_primitive_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


WARMUP_FRAMES = 2
# views planned a second of window: frames of 250 ms or more each get one of their own
FRAMES_PER_S = 4
CHECK_FRAMES = 3
# the check's frames are drawn among the window's first ones
CHECK_AMONG = 40
TRACE_FRAMES = 3


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str,
             t0: float | None = None, keep: dict | None = None) -> tuple[dict, dict]:
    """Set up, measure and check one run; returns (result without
    ``checks``, {number: (value, limit)}).  ``t0``: where set-up began
    (the call, by default); ``keep``: a dict that receives the checked
    frames (``control.py`` reads them again)."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    config, workload = cell["config"], cell["workload"]
    module = spec.entry(workload["entry"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # 1. set-up
    marks = [("start", time.perf_counter())]
    n_frames = max(1, math.ceil(seconds * FRAMES_PER_S))
    entry = module.Entry(config, workload, seed, n_frames, WARMUP_FRAMES, dev, marks)
    warm_s = []
    for j in range(WARMUP_FRAMES):
        x = entry.inputs(-j - 1)
        t = time.perf_counter()
        entry(-j - 1, x)
        sync()
        warm_s.append(time.perf_counter() - t)
    # the check's frames (fewer where a short window will not reach them)
    among = min(CHECK_AMONG, max(1, int(0.8 * seconds / max(warm_s[-1], 1e-3))))
    sample = np.random.default_rng([seed, 5]).choice(among, size=min(CHECK_FRAMES, among),
                                                     replace=False)
    sample = set(int(i) for i in sample)
    readers = {m["name"]: spec.reader(m["name"]) for m in cell["per_layer"]} if trace else {}
    gc.collect()
    if cuda:  # the allocator keeps what the warm-up grew; only its peak starts anew
        torch.cuda.reset_peak_memory_stats(dev)
    sync()

    # 2. the window
    t_start = time.perf_counter()
    setup_s = t_start - t0
    capture = entry.capture
    latencies, failed, i = [], 0, 0
    deadline = t_start + seconds
    # the traced run: the stage timer comes on for the window's second half
    half = t_start + 0.5 * seconds if trace else math.inf
    timer, spans_from, model_s0, observed = None, None, entry.model_s(), {}
    while (now := time.perf_counter()) < deadline:
        if timer is None and i and now >= half:
            from .trace import span_timer

            observed.update(plain_frames=i, plain_s=now - t_start,
                            model_s=entry.model_s() - model_s0)
            timer, spans_from = span_timer(dev), i
            entry.set_timer(timer)
        x = entry.inputs(i)
        if i in sample:
            capture.start(i)
        t = time.perf_counter()
        try:
            out = entry(i, x)
        except Exception:  # a frame that fails is counted and the window goes on
            traceback.print_exc()
            failed += 1
            out = None
        latencies.append(time.perf_counter() - t)
        capture.stop(out)
        i += 1
    sync()
    window_s = time.perf_counter() - t_start
    frames = len(latencies)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # 3. the traced frames
    if trace:
        from .trace import Launches, read_trace

        if timer is not None:
            observed.update(frames=frames - spans_from, stages=dict(timer.totals))
        launches = Launches(readers)
        launches.on = True
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                    + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
                                    ) as prof:
            for j in range(TRACE_FRAMES):
                x = entry.inputs(i + j)
                with torch.profiler.record_function("portbench:frame"):
                    entry(i + j, x)
                    sync()
        launches.on = False
        launches.close()
        observed["trace"] = read_trace(prof)
        observed["launches"] = launches.records
        del prof
    summary = entry.summary(WARMUP_FRAMES)

    # 4. the check, once the program's state is freed
    sampled = {k: {"capture": v, "inputs": entry.inputs(k), "rng": entry.frame_rng(k)}
               for k, v in capture.frames.items() if k < frames}
    if keep is not None:
        keep.update(sampled)
    entry.close()
    del entry, capture
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = module.compare(config, workload, seed, sampled, dev) if sampled else {}
    limits = workload["limits"]
    # a number that is missing or not finite prints as null and fails
    checks = {k: (v if isinstance(v, (int, float)) and math.isfinite(v) else None, lim)
              for k, lim in limits.items() for v in [numbers.get(k)]}
    correct = failed == 0 and bool(sampled) and all(
        v is not None and v <= lim for v, lim in checks.values())

    parts = ", ".join(f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(marks, marks[1:]))
    _log(f"portbench: {cell['name']} seed {seed}: {frames} frames in {window_s:.3f} s, "
         f"{failed} failed, set-up {setup_s:.3f} s (before it {marks[0][1] - t0:.2f} s, "
         f"then {parts} s; warm-up frames "
         f"{[round(s, 3) for s in warm_s]} s), checked frames {sorted(sampled)} "
         f"in {time.perf_counter() - t_check:.1f} s; {summary}")
    result = {"correct": correct, "attempted": frames, "failed": failed}
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = readers[m["name"]].read(observed)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        lat_ms = np.asarray(latencies) * 1e3
        e2e = {"setup_s": setup_s, "frame_ms": 1e3 * window_s / max(frames, 1),
               "frame_ms_p90": float(np.percentile(lat_ms, 90)) if frames else float("inf"),
               "peak_mem_gib": peak / 2**30}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell["end_to_end"]}
        _log(f"portbench: frame latencies ms, min {lat_ms.min():.3f} median "
             f"{np.median(lat_ms):.3f} max {lat_ms.max():.3f}; beyond p90: "
             f"{int((lat_ms > e2e['frame_ms_p90']).sum())}; in order: "
             f"{[int(v) for v in lat_ms]}")
    result["device"] = {"platform": "gpu" if cuda else dev.type,
                        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                        "count": cell["entry"]["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        tr = observed["trace"]
        result["device"].update(busy_s=tr.get("busy_s", 0.0), window_s=tr.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": tr.get("ops", []), "idle_gaps": tr.get("gaps", [])}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = spec.ROOT
    # every cache the run may write stays at a fixed path in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "portbench" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "portbench" / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    try:
        cell = spec.cell(spec.load(root), args.workload, root)
    except (OSError, KeyError, ValueError) as e:
        _log(f"portbench: {e}")
        return 2
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"portbench: the cell needs {chips} CUDA card(s); "
             f"torch.cuda.is_available() {torch.cuda.is_available()}, "
             f"device_count {torch.cuda.device_count()}")
        return 3
    seed = args.seed & (2**63 - 1)
    result, checks = run_cell(cell, seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    found = forbidden_modules()
    if found:
        _log(f"portbench: loaded after the window: {', '.join(found)}")
        return 4
    _log(f"portbench: card {card_info()}")
    for name, (value, limit) in checks.items():
        _log(f"check {name}: {value!r} (limit {limit!r})")
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
