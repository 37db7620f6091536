"""Run a function on n ranks of a fresh process group.

    results = run(fn, n, backend="gloo", device="cpu", args=(...))

Each rank is a process started with ``torch.multiprocessing``'s spawn
context.  It joins a process group through a ``FileStore`` in a temporary
directory, builds the (dp, sp) mesh (``parallel.mesh.make_mesh``), calls
``fn(mesh, *args)`` and hands its result back (tensors moved to the CPU);
``run`` returns the results in rank order.  ``fn`` must be a module-level
function and ``args`` CPU data that ``torch.save`` writes: the ranks read
it from a file.

The backend and the device are the caller's, and nothing is chosen for
it: ``nccl`` puts rank r on ``cuda:r`` and needs a card per rank;
``gloo`` on ``cuda`` puts every rank on ``cuda:0``; ``gloo`` on ``cpu``
runs each rank on one torch thread.  The process group's timeout bounds
every collective, so ranks that diverge fail instead of hanging; a rank
that fails ends the others.  On a card the kernels are built here, before
the ranks start, so that no two ranks run nvcc.
"""

from __future__ import annotations

import datetime
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import make_mesh

BACKENDS = ("gloo", "nccl")


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(rank: int, n: int, backend: str, device: str, tmp: str, timeout: float,
               fn) -> None:
    out = Path(tmp) / f"rank{rank}.pt"
    try:
        args = torch.load(Path(tmp) / "args.pt", weights_only=False)
        if device == "cpu":
            torch.set_num_threads(1)
            dev = "cpu"
        else:
            dev = f"cuda:{rank if backend == 'nccl' else 0}"
            torch.cuda.set_device(dev)
        store = dist.FileStore(str(Path(tmp) / "store"), n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(make_mesh(n, device=dev), *args)
            if device != "cpu":
                torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        torch.save({"ok": True, "result": _to_cpu(result)}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise SystemExit(1)


def check(n: int, backend: str, device: str) -> None:
    """Raise unless ``n`` ranks can run on ``backend`` and ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r} is neither 'cpu' nor 'cuda'")
    if n < 1:
        raise ValueError(f"{n} ranks")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("nccl runs on CUDA devices only")
        if n > torch.cuda.device_count():
            raise RuntimeError(f"nccl needs a card per rank: {n} ranks, "
                               f"{torch.cuda.device_count()} cards")


def run(fn, n: int, backend: str, device: str, args: tuple = (), timeout: float = 60.0,
        deadline: float = 900.0) -> list:
    """``fn(mesh, *args)`` on ``n`` ranks; their results in rank order.

    ``timeout`` (s) bounds each collective, ``deadline`` (s) the whole run.
    Raises with a rank's traceback if any rank fails."""
    check(n, backend, device)
    if device == "cuda":
        from ..ops import _build

        _build.build_all()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="sp_launch_") as tmp:
        torch.save(tuple(args), Path(tmp) / "args.pt")
        procs = [ctx.Process(target=_rank_main, args=(r, n, backend, device, tmp, timeout, fn))
                 for r in range(n)]
        for p in procs:
            p.start()
        t_end = time.monotonic() + deadline
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > t_end:
                    raise TimeoutError(f"{n} ranks did not finish in {deadline} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            f = Path(tmp) / f"rank{r}.pt"
            rec = torch.load(f, weights_only=False) if f.is_file() else None
            if rec is not None and rec["ok"]:
                results.append(rec["result"])
            else:
                why = rec["error"] if rec is not None else f"exit code {p.exitcode}"
                errors.append(f"rank {r}: {why}")
        if errors:
            raise RuntimeError(f"{len(errors)} of {n} ranks failed:\n" + "\n".join(errors))
    return results
