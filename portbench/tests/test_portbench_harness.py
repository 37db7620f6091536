"""CPU tests of the port's benchmark harness (``portbench/``).

Run from the repository's root: ``python -m pytest portbench/tests -q``.
The tiny cells (``tiny.py``) drive a whole run on the CPU, the check
included; the faults below break the timed path underneath and must turn
``correct`` false.  The test marked ``cuda`` runs the control at a cell's
own size on the card and skips without one.
"""

from __future__ import annotations

import ast
import importlib
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from portbench import check, counts, spec
from portbench.run import forbidden_modules, main, run_cell
from portbench.tests.tiny import tiny_cell

ROOT = spec.ROOT
CELLS = ("tum_desk.keyframe", "void150.first_pass")
SEED = 2**31 + 1


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_names_and_units_use_the_allowed_characters():
    bench = spec.load()
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), names
    assert len(set(names[:len(bench["configs"]) + len(bench["workloads"])])) == \
        len(bench["configs"]) + len(bench["workloads"])
    assert all(spec.UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in bench["end_to_end"] + bench["per_layer"])


def test_every_cell_config_and_metric_is_found_by_name():
    bench = spec.load()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell["workload"]["config"] == w["config"]
        assert cell["config"]["name"] == w["config"]
        assert "setup_s" in [m["name"] for m in cell["end_to_end"]]
        entry = spec.entry(cell["workload"]["entry"])
        assert callable(entry.Entry) and callable(entry.compare)
    for m in bench["per_layer"]:
        r = spec.reader(m["name"])
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"], m["moves"])
        if hasattr(r, "WRAPS"):  # the program function the reader's launches come from
            module, fn = r.WRAPS.split(":")
            assert callable(getattr(importlib.import_module(module), fn)), r.WRAPS


def test_a_new_cell_needs_no_edit(tmp_path):
    """A dummy cell added to a copy is found through new files and a new
    entry alone: every file that was there stays byte for byte."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    wl = json.loads((tmp_path / "portbench/workloads/tum_desk.keyframe.json").read_text())
    wl["why"] = "a test"
    (tmp_path / "portbench/workloads/tum_desk.dummy.json").write_text(json.dumps(wl))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tum_desk.dummy", "config": "tum_desk",
                               "traffic": "dummy", "chips": 1, "why": "a test"})
    before.pop(tmp_path / "BENCHMARK.json")
    sys.path.insert(0, str(tmp_path))
    try:
        copy_spec = importlib.util.spec_from_file_location(
            "portbench_copy_spec", tmp_path / "portbench" / "spec.py")
        mod = importlib.util.module_from_spec(copy_spec)
        copy_spec.loader.exec_module(mod)
        cell = mod.cell(bench, "tum_desk.dummy", tmp_path)
    finally:
        sys.path.remove(str(tmp_path))
    assert cell["workload"]["why"] == "a test"
    assert all(p.read_bytes() == b for p, b in before.items())


def test_vit_h_flops_match_a_hand_count():
    """ViT-H on 64x64 tokens: 32 blocks of projections and MLP (161.06
    GFLOP each), four global attentions over 4096 tokens, 28 windowed ones
    over the 25 windows' real tokens, the patch embedding and the neck:
    about 5.63 TFLOP."""
    sam = spec.cell(spec.load(), "tum_desk.keyframe")["config"]["sam"]
    L, D = 4096, 1280
    per_block = 2 * L * D * 3 * D + 2 * L * D * D + 2 * 2 * L * D * 4 * D
    windows = 16 * 196**2 + 8 * 112**2 + 64**2
    attn = 4 * (4 * L * L * D + 4 * L * 64 * D) + 28 * (4 * windows * D + 4 * L * 14 * D)
    hand = 32 * per_block + attn + 2 * L * 768 * D + 2 * L * D * 256 + 2 * L * 2304 * 256
    assert counts.sam_encoder_flops(sam) == hand
    assert 5.6e12 < hand < 5.7e12


def test_k3_bytes_equal_chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for shape in [(900, 256, 4, (768, 1024)), (300, 256, 4, (768, 1024)), (3, 128, 8, (1000, 700)),
                  (96, 256, 4, (1024, 1024)), (1, 64, 16, (17, 1024))]:
        assert counts.k3_bytes(*shape) == chip_smoke.k3_bytes(*shape)
    assert counts.bound_ms(1e9, 1e12) == pytest.approx(chip_smoke.bound_ms(1e9, 1e12)[0])


def test_a_run_without_a_card_fails_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = main(["--workload", "tum_desk.keyframe", "--seed", str(SEED), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_the_no_jax_check_compares_whole_top_level_names():
    assert forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["super_primitive_tpu.frontend"]) == ["super_primitive_tpu"]
    assert forbidden_modules(["super_primitive_tpu_torch", "super_primitive_tpu_torch.ops",
                              "jaxtyping", "flaxen"]) == []


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            for n in names:
                assert n.split(".")[0] not in ("super_primitive_tpu_torch", "super_primitive_tpu",
                                               "jax", "jaxlib", "flax"), (path, n)


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct(name):
    result, checks = run_cell(tiny_cell(name), SEED, 2.0, False, "cpu")
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "frame_ms", "frame_ms_p90", "peak_mem_gib"}


def test_a_tiny_traced_run_reports_the_spans():
    result, _ = run_cell(tiny_cell("void150.first_pass"), SEED, 2.0, True, "cpu")
    assert result["correct"]
    for name in ("normals_ms", "sam_masks_ms", "bini_ms", "post_ms", "completion_ms",
                 "frame_mfu_pct"):
        assert result["metrics"][name]["value"] > 0, name


def _flip_a_mask_pixel(monkeypatch):
    from super_primitive_tpu_torch.nets.sam import predictor

    orig = predictor.select_from_lowres

    def altered(*args, **kwargs):
        packed, *rest = orig(*args, **kwargs)
        packed = packed.clone()
        packed[:, 40, 10] ^= 0x10  # one pixel of every prompt's picked mask
        return (packed, *rest)

    monkeypatch.setattr(predictor, "select_from_lowres", altered)


def _half_the_prompts(monkeypatch):
    from super_primitive_tpu_torch.nets.sam import predictor

    orig = predictor.PromptRounds.select_dispatch

    def half(self, points, *args, **kwargs):
        return orig(self, np.asarray(points)[: max(1, len(points) // 2)], *args, **kwargs)

    monkeypatch.setattr(predictor.PromptRounds, "select_dispatch", half)


def _bini_state_unchanged(monkeypatch):
    from super_primitive_tpu_torch.ops import stencil

    def unchanged(b, x0, *args, **kwargs):
        return x0.clone(), torch.zeros(b.shape[0], dtype=torch.int32)

    monkeypatch.setattr(stencil, "bini_cg", unchanged)


def _normals_altered(monkeypatch):
    from super_primitive_tpu_torch.nets import nnet

    orig = nnet.NNET.forward

    def altered(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        return torch.cat([out[:, :1] * -1.0, out[:, 1:]], dim=1)

    monkeypatch.setattr(nnet.NNET, "forward", altered)


FAULTS = {"mask_pixel_flipped": (_flip_a_mask_pixel, "select_mismatch"),
          "half_the_prompts_left_out": (_half_the_prompts, "select_mismatch"),
          "bini_state_unchanged": (_bini_state_unchanged, "bini_err"),
          "normals_altered": (_normals_altered, "normals_err")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    result, checks = run_cell(tiny_cell("tum_desk.keyframe"), SEED, 2.0, False, "cpu")
    assert not result["correct"]
    value, limit = checks[number]
    assert value > limit, checks


def test_the_control_is_not_correct():
    """The reference one precision down in the program's place fails one
    of the cell's limits (at the tiny size here; PERF.md has its readings
    at the cell's own size on the card)."""
    from portbench.control import readings

    cell = tiny_cell("tum_desk.keyframe")
    r = readings(cell, SEED, 2.0, "cpu")
    limits = cell["workload"]["limits"]
    assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.control import readings

    for name in CELLS:
        cell = spec.cell(spec.load(), name)
        r = readings(cell, SEED, 4.0, "cuda")
        limits = cell["workload"]["limits"]
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r["control"].items()), r


def test_the_check_counts_differences():
    a = np.zeros((2, 3))
    assert check._count_diff(a, a) == 0
    assert check._count_diff(a, a + np.eye(2, 3)) == 2
    assert check._count_diff(a, np.zeros((3, 3))) == 9
