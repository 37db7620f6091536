"""VOID depth-completion evaluation with the PyTorch port.

Mirrors the repository's ``evaluate_void.py``:

    python -m super_primitive_tpu_torch.evaluate_void --dataset DIR \\
        [--config super_primitive_tpu_torch/configs/void_dataset.yaml] \\
        [--sam-ckpt sam.npz --nnet-ckpt nnet.npz | --stub-frontend] \\
        [--max-images N] [--device cuda|cpu]

``DIR`` is a tree in the VOID layout (``data/void.py``).  The frontend is
the real SAM and NNET from the ``.npz`` trees ``convert_checkpoints.py``
writes (``frontend.process_frame.build_frontend``), or with
``--stub-frontend`` the ground-truth patch stub (``frontend.stub.
PatchSegmentFrontend``), which runs the whole completion without the nets.
Either way the completion's dense part runs on ``--device``: the card
(``cuda``, the default), which raises if there is none, or ``cpu``.

Prints, per image, the validity rate, the wall time and the stage split;
then the two metric tables of the JAX evaluation (the completion filled by
griddata, and its valid pixels only) and the validity-rate statistics.
"""

from __future__ import annotations

import argparse
import copy
import json
import random
import time

import numpy as np


def evaluate(dc, ds, n: int) -> dict:
    """Complete the first ``n`` samples of ``ds`` with ``dc`` (a
    ``DepthCompletion``), printing as the JAX evaluation does plus each
    image's wall time, segments per pass and stage split.  Returns the
    per-image records (validity rate, wall s, sparse points, (segments,
    visible) per pass, stage seconds), the two averaged metric tables and
    the validity rates."""
    from .depth_completion import metrics as M
    from .depth_completion.fill_in import fill_single_griddata
    from .utils.timing import StageTimer

    frontend = dc.frontend
    avg_filled = M.ErrorMetricsAverager()
    avg_valid = M.ErrorMetricsAverager()
    validity_rates, images = [], []
    for i in range(n):
        s = ds[i]
        timer = StageTimer(frontend.device)
        frontend.timer = dc.timer = timer
        t0 = time.perf_counter()
        observe = getattr(frontend, "observe", None)
        if observe is not None:
            observe(s)
        with timer.stage("completion"):
            depths, invalid = dc.depth_completion(s["image"], s["intrinsics"], s["sparse_depth"])
        with timer.stage("fill_in"):
            filled = fill_single_griddata(copy.copy(depths), invalid)
        wall = time.perf_counter() - t0

        mask = s["gt_valid"]
        m1 = M.ErrorMetrics()
        m1.compute(filled, s["gt_depth"], mask)
        avg_filled.accumulate(m1)

        mask_joint = np.logical_and(depths > 1e-6, mask)
        m2 = M.ErrorMetrics()
        m2.compute(depths, s["gt_depth"], mask_joint)
        avg_valid.accumulate(m2)

        validity_rates.append((depths > 1e-6).mean())
        images.append({"validity_rate": float(validity_rates[-1]), "wall_s": wall,
                       "sparse_points": int((s["sparse_depth"] > 1e-6).sum()),
                       "segments": list(dc.segments), "stage_s": dict(timer.totals),
                       "counters": dict(timer.counters)})
        print(f"[{i + 1}/{n}] validity rate {validity_rates[-1]:.3f}")
        print(f"[{i + 1}/{n}] wall {wall:.3f} s, sparse points {images[-1]['sparse_points']}, "
              f"(segments, visible) per pass {dc.segments}, stage seconds "
              + json.dumps({k: round(v, 4) for k, v in timer.totals.items()})
              + f", counters {json.dumps(dict(timer.counters))}", flush=True)

    tables = {}
    for name, avg in (("filled", avg_filled), ("valid-only", avg_valid)):
        avg.average()
        tables[name] = {k: float(v) for k, v in avg.as_dict().items()}
        print(f"\n=== {name} over {avg.total_count} samples ===")
        for k, v in tables[name].items():
            print(f"  {k:>10}: {v:8.3f}")
    print(
        f"\nvalidity rate: mean {np.mean(validity_rates):.3f} "
        f"std {np.std(validity_rates):.3f} min {np.min(validity_rates):.3f} "
        f"median {np.median(validity_rates):.3f}"
    )
    return {"images": images, "tables": tables,
            "validity_rates": [float(v) for v in validity_rates]}


def main(argv=None) -> dict:
    """Run the evaluation; returns :func:`evaluate`'s result with the
    ``DepthCompletion`` it ran (``"completion"``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--sam-ckpt", default=None, help=".npz converted SAM tree")
    ap.add_argument("--nnet-ckpt", default=None, help=".npz converted NNET tree")
    ap.add_argument("--stub-frontend", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    np.random.seed(144)
    random.seed(144)

    from .config import load_config
    from .data.void import VoidDataset
    from .depth_completion.completion import DepthCompletion
    from .run_sfm import require_device

    device = require_device(args.device)
    config = load_config(args.config) if args.config else load_config({})
    ds = VoidDataset(args.dataset)

    if args.stub_frontend:
        from .frontend.stub import PatchSegmentFrontend

        frontend = PatchSegmentFrontend(patch=9, device=device)
    elif args.sam_ckpt and args.nnet_ckpt:
        from .convert import load_npz_tree
        from .frontend.process_frame import build_frontend

        frontend = build_frontend(config, load_npz_tree(args.sam_ckpt),
                                  load_npz_tree(args.nnet_ckpt), device=device)
    else:
        raise ValueError("pass --sam-ckpt and --nnet-ckpt (converted .npz trees) or "
                         "--stub-frontend")

    dc = DepthCompletion(frontend)
    n = len(ds) if args.max_images is None else min(len(ds), args.max_images)
    result = evaluate(dc, ds, n)
    result["completion"] = dc
    return result


if __name__ == "__main__":
    main()
