"""Build the package's CUDA sources and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, all sources in parallel (one nvcc
each), into ``build/kernels/`` beside the package at first use.  A library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

No ``--use_fast_math``: the divisions and square roots in the kernels must
round to nearest as the JAX reference does.  ``-fmad=false`` keeps nvcc from
contracting a product and a sum into one rounding, so each kernel repeats
the plain PyTorch version's roundings operation by operation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("bini_apply.cu", "bini_cg.cu", "phase_counts.cu", "ext_attention.cu",
           "sam_frame.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    the one on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _library_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.name == source or f.suffix == ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all at once.

    Returns {"seconds": wall time, "log": {source: nvcc's output}}.  Raises
    if any compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        lib = _library_path(src)
        if lib.is_file():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    log, failed = {}, []
    for src, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        log[src] = out
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(log[s] for s in failed)
        )
    return {"seconds": time.perf_counter() - t0, "log": log}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (e.g. "bini_cg.cu"), built first if
    needed."""
    lib = _loaded.get(source)
    if lib is None:
        path = _library_path(source)
        if not path.is_file():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib
