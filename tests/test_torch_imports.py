"""The PyTorch port stands alone: no module of ``super_primitive_tpu_torch``
and nothing in ``chip_smoke.py`` imports JAX, Flax, optax, OpenCV, PIL,
matplotlib, transformers or the JAX package, and importing the dataset
loaders (the native one too), the depth completion, ``evaluate_void``, the
odometry loop and its checkpoints, ``viz/``, ``run_sfm``,
``convert_traj_to_tum``, the multi-device layer ``parallel/``, the normal
modes, the SAM predictor and image encoder, K4's module (``ops.attention``),
the checkpoint converter and its validation and
oracle modules and the day-0 rehearsal loads none of them; and
``chip_smoke.py`` fails without printing a result where there is no card,
or where the package is not beside it."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|cv2|PIL|matplotlib|transformers"
    r"|super_primitive_tpu(?!_torch))\b",
    re.MULTILINE,
)


def port_sources():
    files = sorted((REPO / "super_primitive_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


STANDALONE_MODULES = [
    "data", "data.image_io", "data.undistort", "data.transforms", "data.tum",
    "data.replica", "data.void", "depth_completion.completion", "depth_completion.fill_in",
    "depth_completion.metrics", "evaluate_void", "eval.dataset_trees",
    "odometry.io", "odometry.odometry", "lie.sim3", "viz", "viz.export", "viz.viewer",
    "viz.live", "viz.serve", "run_sfm", "convert_traj_to_tum", "eval.e2e_synthetic",
    "parallel.mesh", "parallel.launch", "parallel.dryrun",
    "data.native_loader", "cost.normal_modes", "cost.photometric", "image.resize",
    "nets.sam.predictor", "nets.hf_oracle", "nets.validate", "convert_checkpoints",
    "day0_rehearsal", "ops.attention", "nets.sam.image_encoder",
]


@pytest.mark.parametrize("module", STANDALONE_MODULES)
def test_module_loads_nothing_forbidden(module):
    """Importing the module in a fresh interpreter loads no forbidden
    package, not even through another module."""
    code = (f"import sys, super_primitive_tpu_torch.{module}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'cv2', 'PIL', 'matplotlib', 'transformers', "
            "'super_primitive_tpu')); "
            "print(bad)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]", p.stdout


def test_kernel_sources_are_packaged():
    csrc = REPO / "super_primitive_tpu_torch" / "ops" / "csrc"
    assert {p.name for p in csrc.iterdir()} >= {"bini_apply.cu", "bini_cg.cu", "bini_stencil.cuh",
                                                "phase_counts.cu", "ext_attention.cu"}
    assert (REPO / "super_primitive_tpu_torch" / "data" / "csrc" / "loader.cpp").is_file()
    text = (REPO / "pyproject.toml").read_text()
    assert '"csrc/*.cu"' in text and '"csrc/*.cuh"' in text and '"csrc/*.cpp"' in text


def run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = run_smoke(REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and "no CUDA device" in p.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = run_smoke(tmp_path)
    assert p.returncode != 0 and '"ok"' not in p.stdout
