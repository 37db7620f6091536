"""CPU tests of ``metrics/sam_frame_on_card_pct.py``, the share of
keyframes whose SAM input frame a kernel made on the card.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import pytest
import torch

from portbench import spec
from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 11
NAME = "sam_frame_on_card_pct"


def test_the_share_counts_frames_made_on_the_card():
    reader = spec.reader(NAME)
    on = [("sam_frame_on_card", 1), ("prompts_decoded", 300)] * 3
    assert reader.read({"launches": {NAME: on}}) == 100.0
    mixed = on[:2] + [("sam_frame_on_host", 1)]
    assert reader.read({"launches": {NAME: mixed}}) == 50.0


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    """The parent counts neither name: the reader returns None there."""
    from super_primitive_tpu_torch.utils import timing

    reader = spec.reader(NAME)
    assert reader.read({"launches": {NAME: [("masks_kept", 2), ("segments", 60)]}}) is None
    assert reader.read({"launches": {}}) is None
    monkeypatch.delattr(timing, "count")
    assert reader.read({"stages": {}, "launches": {}}) is None


def test_a_tiny_traced_run_reports_the_share():
    """The tiny cell's predictor is on the CPU, so its frames are made by
    the plain version, on the host: 0%."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        result, _ = run_cell(tiny_cell("tum_desk.keyframe"), SEED, 6.0, True, "cpu")
    finally:
        torch.set_num_threads(n)
    assert result["correct"]
    assert result["metrics"][NAME] == {"value": 0.0, "unit": "%"}


@pytest.mark.parametrize("cell", ("tum_desk.keyframe", "void150.first_pass"))
def test_both_cells_list_the_share(cell):
    assert NAME in [m["name"] for m in spec.cell(spec.load(), cell)["per_layer"]]
