"""Time K2 (``ops.stencil.bini_cg``) on the VO path's own inputs, on one
CUDA card.

    python super_primitive_tpu_torch/eval/compare_k2.py [--package DIR]
        [--record FILE] [--calls FILE] [--sweep FILE] [--routes] [--out FILE]

Run as a file, not with ``-m``: it imports ``super_primitive_tpu_torch``
from DIR (default: the checkout that holds this script), so the same
script times the K2 of another commit's checkout on the same inputs.
  --record FILE  run the 12-frame VO slice (``run_e2e("adam")``) and save
                 the inputs of every K2 call it makes to FILE;
  --calls FILE   time ``bini_cg`` on those inputs: the first call at each
                 (N, H, W), with its longest segment's iterations and µs
                 per iteration, then every call of the run;
  --sweep FILE   on the first call at each shape, K2 on every cluster size
                 (1, 2, 4, 8, 16) and CTA size that holds the field,
                 launched through the kernel's C interface (``cg_plan``'s
                 choice is one of them);
  --routes       BiNI's two CG routes on BiNI-shaped fields on both sides
                 of what K2 holds: K2 (where the package's K2 holds the
                 field) and ``_pcg`` with K1 once an iteration.
Prints one JSON line per measurement, and writes them all to ``--out``.
Times are CUDA events around back-to-back calls, over the count; the K1
route, whose loop reads its stop test on the host, is timed on the host
clock.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

SWEEP_CLUSTERS = (1, 2, 4, 8, 16)
SWEEP_THREADS = (64, 128, 256, 512, 640, 1024)
# fields on both sides of what K2 holds (at most 81,920 pixels, fewer for
# wide fields): the full 240x320 field, the JAX package's largest K2 field
# class (under 8 MiB of ten f32 fields) and the two-frame field
ROUTE_SHAPES = ((8, 240, 320), (4, 100, 800), (4, 340, 600), (8, 480, 640))


def time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def emit(result: dict, key: str, row: dict) -> None:
    result.setdefault(key, []).append(row)
    print(json.dumps({key: row}), flush=True)


def record(stencil, path: Path, result: dict) -> None:
    """Run the VO slice, keeping a host copy of every K2 call's inputs."""
    from super_primitive_tpu_torch.eval.e2e_synthetic import run_e2e

    calls = []
    kernel = stencil.bini_cg

    def spy(*args):
        calls.append([a.cpu() if torch.is_tensor(a) else a for a in args])
        return kernel(*args)

    stencil.bini_cg = spy
    try:
        r = run_e2e("adam", frames=12, device="cuda",
                    save_path=str(path.parent / "compare_k2_vo"))
    finally:
        stencil.bini_cg = kernel
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(calls, path)
    bini_s = r["timer"].totals.get("bini", float("nan"))
    emit(result, "vo", {"keyframes": r["keyframes"], "ate": r["ate"]["rmse"],
                        "wall_s": r["wall_s"], "bini_s": bini_s,
                        "bini_ms_per_kf": bini_s * 1e3 / max(r["keyframes"], 1),
                        "k2_calls": len(calls)})


def load_calls(path: Path):
    calls = [[a.cuda() if torch.is_tensor(a) else a for a in c] for c in torch.load(path)]
    first = {}
    for args in calls:
        first.setdefault(tuple(args[0].shape), args)
    return calls, first


def time_calls(stencil, path: Path, result: dict) -> None:
    calls, first = load_calls(path)
    for shape, args in first.items():
        _, it = stencil.bini_cg(*args)
        ms = time_ms(lambda: stencil.bini_cg(*args))
        emit(result, "shape", {"shape": list(shape), "max_iters": int(it.max()),
                               "sum_iters": int(it.sum()), "ms": ms,
                               "us_per_iter": ms * 1e3 / max(int(it.max()), 1)})
    print(json.dumps({"first_calls_ms": sum(r["ms"] for r in result["shape"])}), flush=True)
    every = sum(time_ms(lambda: stencil.bini_cg(*args), reps=2) for args in calls)
    emit(result, "every_call", {"calls": len(calls), "ms": every})


def sweep(stencil, path: Path, result: dict) -> None:
    """K2 at each (cluster, threads) that holds the field, through the C
    interface; ``same_bits`` compares with ``cg_plan``'s launch."""
    _, first = load_calls(path)
    lib = stencil._lib_cg()
    for (N, H, W), args in first.items():
        want, _ = stencil.bini_cg(*args)
        for C in SWEEP_CLUSTERS:
            for T in SWEEP_THREADS:
                if not stencil.cg_pixels_per_thread(H, W, C, T):
                    continue
                if lib.bini_cg_max_clusters(H, W, C, T) <= 0:
                    continue
                out = torch.empty_like(args[0])
                iters = torch.empty(N, dtype=torch.int32, device=out.device)

                def run():
                    err = lib.bini_cg_launch(
                        *(t.data_ptr() for t in args[:8]), out.data_ptr(), iters.data_ptr(),
                        N, H, W, int(args[8]), float(args[9]), C, T,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"K2 at cluster {C}, threads {T}: CUDA error {err}")

                ms = time_ms(run)
                emit(result, "sweep", {"shape": [N, H, W], "cluster": C, "threads": T,
                                       "plan": (C, T) == tuple(stencil.cg_plan(H, W))[:2],
                                       "ms": ms, "same_bits": bool(torch.equal(out, want))})


def bini_inputs(bini, N, H, W, seed):
    """BiNI-shaped K2 inputs from ``_system`` on random masks and unit
    normals, with a warm start."""
    g = torch.Generator().manual_seed(seed)
    masks = torch.rand(N, H, W, generator=g) > 0.3
    normals = torch.randn(H, W, 3, generator=g)
    normals[..., 2] = -normals[..., 2].abs() - 1.0
    normals = normals / normals.norm(dim=-1, keepdim=True)
    K = torch.tensor([[1.08 * W, 0.0, W / 2], [0.0, 1.08 * W, H / 2], [0.0, 0.0, 1.0]])
    D, c_u, c_v = bini._coefficients(normals, K)
    em = {k: v.float() for k, v in bini._edge_masks(masks).items()}
    q, b, diag = bini._system(D, c_u, c_v, em, torch.rand(N, H, W, generator=g),
                              torch.rand(N, H, W, generator=g))
    qs = [q[k].expand(N, H, W).contiguous().cuda() for k in ("up", "um", "vp", "vm")]
    x0 = (0.01 * torch.randn(N, H, W, generator=g) * masks).cuda()
    b = (b * masks).expand(N, H, W).contiguous().cuda()
    return [b, x0, masks.float().cuda(), diag.expand(N, H, W).contiguous().cuda(), *qs,
            1000, 1e-3]


def routes(stencil, bini, result: dict) -> None:
    # a package without ``cg_holds`` (K2 on one CTA a segment) holds every field
    holds = getattr(stencil, "cg_holds", lambda H, W: True)
    for N, H, W in ROUTE_SHAPES:
        args = bini_inputs(bini, N, H, W, seed=5)
        b, x0, maskf, diag, *qs = args[:8]

        def k1_route():
            return bini._pcg(lambda x: stencil.bini_apply(x, *qs), b, x0, maskf.bool(),
                             diag, 1000, 1e-3)

        emit(result, "route", {
            "shape": [N, H, W], "k2_holds": holds(H, W),
            "k1_route_ms": [host_ms(k1_route) for _ in range(2)],
            "k2_ms": time_ms(lambda: stencil.bini_cg(*args), reps=2) if holds(H, W) else None})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose super_primitive_tpu_torch is timed")
    ap.add_argument("--record", type=Path, help="run the VO slice, save K2's inputs here")
    ap.add_argument("--calls", type=Path, help="time K2 on the saved inputs")
    ap.add_argument("--sweep", type=Path, help="sweep K2's launch plans on the saved inputs")
    ap.add_argument("--routes", action="store_true", help="time BiNI's two CG routes")
    ap.add_argument("--out", type=Path, help="write every measurement here as JSON")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_k2: needs a CUDA device")
    sys.path.insert(0, str(a.package.resolve()))
    from super_primitive_tpu_torch.integrate import bini
    from super_primitive_tpu_torch.ops import _build, stencil

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "package": str(Path(stencil.__file__).resolve().parents[1])}
    print(json.dumps(result), flush=True)
    _build.build_all()
    if a.record:
        record(stencil, a.record, result)
    if a.calls:
        time_calls(stencil, a.calls, result)
    if a.sweep:
        sweep(stencil, a.sweep, result)
    if a.routes:
        routes(stencil, bini, result)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
