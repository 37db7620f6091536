"""The day-0 checkpoint path of the PyTorch port (CPU): its
``convert_checkpoints`` against the root ``convert_checkpoints.py`` (the
JAX package's CLI), ``nets/validate.py``, the day-0 rehearsal, and its
full-size leg's function at the tiny configuration.

Bounds: the port's ``.npz`` trees equal the JAX CLI's, leaf for leaf and
bit for bit, on the same synthetic published-name ``.pth`` files, and
each package's loader reads the other's; validation runs tier 1 with every
stage finite (the reference torch packages are not installed here); the
rehearsal reaches a Sim(3) ATE below 0.05, the JAX rehearsal's bound, at
6 frames (the root rehearsal's 8, cut for time).  The leg at ViT-H size
is ``tests/test_torch_day0_full.py`` (slow).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from super_primitive_tpu_torch import convert, convert_checkpoints, day0_rehearsal
from super_primitive_tpu_torch.nets import validate
from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_TINY_TEST
from super_primitive_tpu_torch.nets.synth import synth_nnet_state_dict, synth_sam_state_dict

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Synthetic ``.pth`` files in the published layouts, converted by both
    CLIs."""
    d = tmp_path_factory.mktemp("ckpt")
    sam_pth, nnet_pth = d / "sam_vit_h_4b8939.pth", d / "scannet.pth"
    torch.save({k: torch.from_numpy(v) for k, v in synth_sam_state_dict(VIT_TINY_TEST).items()},
               sam_pth)
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in synth_nnet_state_dict().items()}}, nnet_pth)
    jax_out = {"sam": d / "jax_sam.npz", "nnet": d / "jax_nnet.npz"}
    p = subprocess.run(
        [sys.executable, "convert_checkpoints.py", "--sam", str(sam_pth), "--nnet", str(nnet_pth),
         "--out-sam", str(jax_out["sam"]), "--out-nnet", str(jax_out["nnet"]),
         "--sam-cfg", "tiny", "--cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    port_out = {"sam": d / "port_sam.npz", "nnet": d / "port_nnet.npz"}
    convert_checkpoints.main(["--sam", str(sam_pth), "--nnet", str(nnet_pth),
                              "--out-sam", str(port_out["sam"]),
                              "--out-nnet", str(port_out["nnet"]), "--sam-cfg", "tiny"])
    return {"jax": jax_out, "port": port_out, "sam_pth": sam_pth, "nnet_pth": nnet_pth}


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("net", ["sam", "nnet"])
def test_port_trees_equal_the_jax_cli(checkpoints, net):
    port = convert.load_npz_tree(checkpoints["port"][net])
    assert_trees_equal(port, convert.load_npz_tree(checkpoints["jax"][net]))
    # the JAX package's reader takes the port's file
    with np.load(checkpoints["port"][net], allow_pickle=True) as f:
        assert_trees_equal(f["tree"].item(), port)


def test_load_torch_state_dict_unwraps_and_strips(checkpoints):
    sd = convert_checkpoints.load_torch_state_dict(checkpoints["nnet_pth"])
    assert all(k.startswith("module.") for k in sd)
    stripped = convert.strip_module_prefix(sd)
    want = synth_nnet_state_dict()
    assert sorted(stripped) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(stripped[k], v)


def test_validate_runs_tier_one(checkpoints, capsys):
    image = validate.sample_image((48, 64))
    sam = validate.validate_sam(convert.load_npz_tree(checkpoints["port"]["sam"]),
                                image=image, device="cpu")
    nnet = validate.validate_nnet(convert.load_npz_tree(checkpoints["port"]["nnet"]),
                                  image=image, network_dim=(64, 96), device="cpu")
    out = capsys.readouterr().out
    assert sam["tier"] == nnet["tier"] == 1 and sam["finite"] and nnet["finite"]
    assert len(sam["iou"]) == 9 and abs(nnet["norm_len_mean"] - 1.0) < 1e-4
    assert out.count("tier 1 (the port alone) ran") == 2
    for stage in ("image_embedding", "mask_logits", "iou_pred", "normals", "kappa"):
        assert stage in out


def test_full_size_leg_at_tiny_size(checkpoints, tmp_path):
    """``full_size_leg``, the body of ``--full-size``, at VIT_TINY_TEST: its
    ``.npz`` equals the root CLI's on the leg's own ``.pth``."""
    leg = day0_rehearsal.full_size_leg(tmp_path / "models", checkpoints["port"]["nnet"], "cpu",
                                       sam_cfg="tiny")
    assert leg["pth"].name == "sam_vit_h_4b8939_full.pth" and leg["npz"].is_file()
    assert leg["pth_bytes"] == leg["pth"].stat().st_size > 0
    assert leg["npz_bytes"] == leg["npz"].stat().st_size > 0
    steps = leg["peak_rss_bytes_by_step"]
    assert 0 < leg["rss_start_bytes"] <= steps["write"] <= steps["convert_validate"]
    assert steps["convert_validate"] <= steps["step2"] == leg["peak_rss_bytes"]
    assert leg["peak_device_bytes"] is None
    assert all(leg[k] >= 0 for k in ("write_s", "convert_s", "validate_s", "step2_s"))
    assert np.isfinite(leg["embed_std"]) and leg["embed_std"] > 0
    jax_npz = tmp_path / "jax_sam.npz"
    p = subprocess.run(
        [sys.executable, "convert_checkpoints.py", "--sam", str(leg["pth"]), "--out-sam",
         str(jax_npz), "--sam-cfg", "tiny", "--cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert_trees_equal(convert.load_npz_tree(leg["npz"]), convert.load_npz_tree(jax_npz))


def test_day0_rehearsal(tmp_path):
    result = day0_rehearsal.rehearse(tmp_path / "day0", n_frames=6, device="cpu")
    assert result["ate"]["rmse"] < day0_rehearsal.ATE_LIMIT and result["ate"]["n"] >= 3
    assert result["validation"]["sam"]["finite"] and result["validation"]["nnet"]["finite"]
    assert (tmp_path / "day0" / "models" / "sam_vit_h.npz").is_file()
