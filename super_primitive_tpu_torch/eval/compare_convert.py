"""Host memory and time of converting a ViT-H-sized SAM checkpoint on two or
more source trees, in turns.

    python -m super_primitive_tpu_torch.eval.compare_convert TREE [TREE ...] \\
        [--dir DIR] [--out FILE]

Writes one ViT-H-sized synthetic ``sam_vit_h_4b8939.pth`` (``nets/synth``:
the published names and shapes, 2.56 GB) under ``DIR`` (default: a
temporary directory), in a process of its own.  Then, for each ``TREE`` (a
checkout of this repository, for example an older commit unpacked with
``git archive`` into a git-ignored directory; ``OLD NEW NEW OLD`` runs two
in turns), a fresh process run from that tree takes the ``.pth`` through
the steps of ``convert_checkpoints --sam`` with that tree's functions
(``load_torch_state_dict``, ``sam_to_flax``, ``save_npz_tree``), and a
second fresh process reads the ``.npz`` back (``load_npz_tree``).  Each
process reports its resident set at the start (after its imports) and at
the end of each step, its peak so far there (``ru_maxrss``), and each
step's seconds, in bytes and seconds.  Prints one JSON line a run and,
with ``--out``, writes them all to ``FILE``; deletes the files at the end.

``ru_maxrss`` carries the peak of the process a child was started from;
every process here is started from this one, which never holds the
weights, so what it carries is this process's few tens of MB.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

_WRITE = """
import sys, torch
from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_H
from super_primitive_tpu_torch.nets.synth import synth_sam_state_dict
torch.save({k: torch.from_numpy(v) for k, v in synth_sam_state_dict(VIT_H).items()}, sys.argv[1])
"""

# run inside each tree, with that tree's package
_MEASURE = """
import json, os, resource, sys, time
import torch
from super_primitive_tpu_torch.convert import load_npz_tree, sam_to_flax, save_npz_tree
from super_primitive_tpu_torch.convert_checkpoints import load_torch_state_dict

def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

def step(name, fn):
    t0 = time.perf_counter()
    value = fn()
    out[name] = {"s": time.perf_counter() - t0, "rss": rss(),
                 "peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    return value

pth, npz = sys.argv[2:4]
out = {"start": {"rss": rss(), "peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}}
if sys.argv[1] == "convert":
    sd = step("read", lambda: load_torch_state_dict(pth))
    tree = step("convert", lambda: sam_to_flax(sd, depth=32))
    del sd
    step("write", lambda: save_npz_tree(npz, tree))
else:
    step("load", lambda: load_npz_tree(npz))
print("RESULT " + json.dumps(out), flush=True)
"""


def run(code: str, cwd: Path, *args: str) -> dict:
    """``code`` in a fresh process in ``cwd``; returns its RESULT line."""
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=cwd,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cwd}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(lines[-1][len("RESULT "):]) if lines else {}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--dir", default=None, help="where the files go (default: a temporary one)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    work = Path(args.dir or tempfile.mkdtemp(prefix="compare_convert_"))
    work.mkdir(parents=True, exist_ok=True)
    pth, npz = work / "sam_vit_h_4b8939.pth", work / "sam_vit_h.npz"
    runs = []
    try:
        run(_WRITE, REPO, str(pth))
        for turn, tree in enumerate(args.trees):
            tree = Path(tree).resolve()
            res = {"turn": turn, "tree": str(tree), "pth_bytes": pth.stat().st_size,
                   "convert": run(_MEASURE, tree, "convert", str(pth), str(npz)),
                   "npz_bytes": npz.stat().st_size,
                   "load": run(_MEASURE, tree, "load", str(pth), str(npz))}
            npz.unlink()
            print(json.dumps(res), flush=True)
            runs.append(res)
    finally:
        if args.dir is None:
            shutil.rmtree(work)
        else:
            for path in (pth, npz):
                path.unlink(missing_ok=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return runs


if __name__ == "__main__":
    main()
