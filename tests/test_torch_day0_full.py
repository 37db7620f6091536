"""The day-0 path at the published ViT-H size (CPU; ``slow``: each test
writes and reads 2.56 GB files and peaks at several GB of host memory).

- ``python -m super_primitive_tpu_torch.day0_rehearsal --full-size
  --device cpu``: the rehearsal with its full-size leg (a ViT-H-sized
  ``.pth`` through ``convert_checkpoints --validate`` at the default
  ``vit_h``, then step 2 on the converted tree), the files deleted at the
  end;
- the port's ``convert_checkpoints`` on a ViT-H-sized synthetic ``.pth``
  against the JAX package's ``nets/convert.convert_sam(..., depth=32)`` on
  the same state dict: key for key, value for value.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from super_primitive_tpu.nets import convert as jconvert
from super_primitive_tpu_torch import convert, convert_checkpoints
from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_H
from super_primitive_tpu_torch.nets.synth import synth_sam_state_dict
from test_torch_day0 import assert_trees_equal

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parents[1]


def test_full_size_rehearsal_cli(tmp_path):
    root = tmp_path / "day0"
    p = subprocess.run(
        [sys.executable, "-m", "super_primitive_tpu_torch.day0_rehearsal", "--full-size",
         "--device", "cpu", "--dir", str(root)],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "full-size leg (vit_h) on cpu: .pth 2,564," in p.stdout
    assert "day0_rehearsal OK" in p.stdout
    models = root / "models"
    assert not (models / "sam_vit_h_4b8939_full.pth").exists()
    assert not (models / "sam_vit_h_full.npz").exists()
    assert (models / "sam_vit_h.npz").is_file()


def test_converter_equals_jax_at_vit_h(tmp_path):
    sd = synth_sam_state_dict(VIT_H)
    pth, npz = tmp_path / "sam_vit_h_4b8939.pth", tmp_path / "sam_vit_h.npz"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    convert_checkpoints.main(["--sam", str(pth), "--out-sam", str(npz)])
    pth.unlink()
    got = convert.load_npz_tree(npz)
    want = jconvert.convert_sam(sd, depth=32)
    assert_trees_equal(got, want)
    assert len(got["image_encoder"]) == 32 + 6
