"""The control of ``correct``, and the program's readings beside it: for
each seed, a short run of the cell at its own load, then the compared
numbers of the program and of the control, the plain reference one
precision down in the program's place (the NNET with TF32, SAM in float8
e4m3, BiNI in bf16; the entry's ``compare(control=True)``), on the same
frames.
The limits in a workload file lie between the two readings (PERF.md).

    python3 -m portbench.control --workload tum_desk.keyframe --seconds 6 --seeds 11 12 13

One JSON line a seed on standard output: {"seed", "program": {number:
value}, "control": {number: value}}.  The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from . import spec
from .run import run_cell


def readings(cell: dict, seed: int, seconds: float, device: str) -> dict:
    """One seed's readings of the program and of the control."""
    import torch

    frames: dict = {}
    _, checks = run_cell(cell, seed, seconds, False, device, keep=frames)
    program = {k: v for k, (v, _) in checks.items()}
    control = spec.entry(cell["workload"]["entry"]).compare(
        cell["config"], cell["workload"], seed, frames, device, control=True)
    del frames
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "program": program, "control": control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
