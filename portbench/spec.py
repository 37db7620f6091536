"""The benchmark as data: ``BENCHMARK.json`` at the root, and the files it
names, found by name.

- a configuration: ``portbench/configs/<name>.json`` (the entry's
  ``file``), the program's settings as run, the nets' widths and what was
  assumed;
- a cell: ``portbench/workloads/<name>.json``, the entry it drives, what
  the cell's traffic sets for that entry, and the limits of its compared
  numbers;
- an entry: ``portbench/entries/<entry>.py``, named by the cell file: how
  the program is built and called, what a frame's inputs are, what the
  check observes on the way, and the comparison with the reference;
- a per-layer metric: ``portbench/metrics/<name>.py``, a reader
  ``read(run) -> float | None`` with its ``LAYER``, ``UNIT`` and ``MOVES``,
  and, where it reads a kernel's launches, ``WRAPS`` and ``record``.

A later cell, configuration, entry or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs: its BENCHMARK.json entry,
    its configuration and workload files, and the metrics it reports."""
    entry = _by_name(bench["workloads"], name, "workload")
    config_entry = _by_name(bench["configs"], entry["config"], "configuration")
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "workloads" / f"{name}.json") as f:
        workload = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "entry": entry, "config": config, "workload": workload,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def entry(name: str):
    """The module of entry ``name`` (``entries/<name>.py``)."""
    if not name.isidentifier():
        raise ValueError(f"an entry's name is a Python identifier, not {name!r}")
    return importlib.import_module(f"portbench.entries.{name}")


def reader(name: str):
    """The module of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
