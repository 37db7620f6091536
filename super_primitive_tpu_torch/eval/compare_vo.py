"""The VO slice's time per tracked frame on two or more source trees, in
turns, on one card.

    python -m super_primitive_tpu_torch.eval.compare_vo TREE [TREE ...] \\
        [--frames 12] [--out FILE]

Each ``TREE`` is a checkout of this repository (for example an older
commit unpacked with ``git archive`` into a git-ignored directory); the
same tree may be named more than once, so ``OLD NEW NEW OLD`` runs the
two in turns.  For each, in the order given, a fresh process run from that
tree builds its kernels and then runs ``eval.e2e_synthetic.run_e2e`` at
full width on the card, with Adam and then with GN/LM tracking
(``chip_smoke.py`` phases 7 and 7b without their kernel checks).  Prints
one JSON line a run and, with ``--out``, writes them all to ``FILE``.

ms per tracked frame is the ``track`` and ``fused_frame`` stages' time
over their count, as ``chip_smoke.py`` reports it; the tracking, mapping
and keyframe stages' seconds are reported beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# run inside each tree, with that tree's package
_RUN = """
import json, sys
from pathlib import Path
from super_primitive_tpu_torch.ops import _build
from super_primitive_tpu_torch.eval.e2e_synthetic import run_e2e

STAGES = ("track", "fused_frame", "fused_track", "fused_supp", "fused_gating",
          "mapping_init", "mapping_map", "mapping_supp", "gating", "kf_frontend")
_build.build_all()
out = {}
for solver in ("adam", "gn"):
    r = run_e2e(solver, frames=int(sys.argv[1]), device="cuda",
                save_path=str(Path("build") / "compare_vo" / solver))
    counts, totals = r["timer"].counts, r["timer"].totals
    tracked = counts.get("fused_frame", 0) + counts.get("track", 0)
    track_s = totals.get("fused_frame", 0.0) + totals.get("track", 0.0)
    out[solver] = {"ms_per_tracked_frame": 1000 * track_s / max(tracked, 1),
                   "tracked_frames": tracked, "wall_s": r["wall_s"],
                   "keyframes": r["keyframes"], "ate_sim3": r["ate"]["rmse"],
                   "stage_s": {k: totals[k] for k in STAGES if k in totals}}
print("RESULT " + json.dumps(out), flush=True)
"""


def run_tree(tree: Path, frames: int) -> dict:
    """One process in ``tree``: both solvers; returns their numbers."""
    proc = subprocess.run([sys.executable, "-c", _RUN, str(frames)], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for turn, tree in enumerate(args.trees):
        res = {"turn": turn, "tree": tree, **run_tree(Path(tree).resolve(), args.frames)}
        print(json.dumps(res), flush=True)
        runs.append(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return runs


if __name__ == "__main__":
    main()
