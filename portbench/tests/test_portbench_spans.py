"""CPU tests of the readers of the program's own spans and counters.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
A traced run of each tiny cell (``tiny.py``) reports every one of them.
"""

from __future__ import annotations

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 7
NEW = ("sam_prep_ms", "sam_encode_ms", "keyframe_self_ms", "masks_kept_pct",
       "segments_per_frame", "program_reads_per_frame")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ("tum_desk.keyframe", "void150.first_pass"))
def test_a_tiny_traced_run_reports_the_programs_spans_and_counters(name):
    # long enough that the stage timer, on from the window's half, sees a frame
    result, _ = run_cell(tiny_cell(name), SEED, 6.0, True, "cpu")
    assert result["correct"]
    got = {m: result["metrics"][m]["value"] for m in NEW}
    assert got["sam_prep_ms"] > 0 and got["sam_encode_ms"] > 0
    assert got["keyframe_self_ms"] >= 0
    assert 0 < got["masks_kept_pct"] <= 100
    assert got["segments_per_frame"] >= 1 and got["program_reads_per_frame"] > 0


def test_a_program_without_the_spans_and_counters_reads_nothing(monkeypatch):
    """The parent of these metrics has neither: each reader wraps nothing
    there and returns None."""
    from portbench import spec
    from super_primitive_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "count")
    parent_run = {"stages": {"normals": 0.1, "sam_masks": 0.3}, "frames": 2,
                  "launches": {}, "trace": {"frames": 3}}
    for name in NEW:
        reader = spec.reader(name)
        assert not hasattr(reader, "WRAPS"), name
        assert reader.read(parent_run) is None, name
