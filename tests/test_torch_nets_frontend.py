"""The real-net keyframe frontend of the port against the JAX package's, on
the CPU in float32, with tiny nets: a SAM at the production input size
(1024², 64x64 tokens, window 14 padding to 70, so the decoder's low-res
logits are 256² and K3 counts the x4 upsample) but 32 wide and 2 deep, and
the full EfficientNet-B5 NNET at a 64x96 network input, both on the
synthetic weights (``nets/synth.py``).

- The keyframe of a ``FrontProcessor`` on those nets (both prompt rounds
  through the device selection path, BiNI, the depth split): regions and
  keypoints identical, log-depths within 1e-3 (the fake-model frontend
  test's bound).
- Both prompt rounds' statistics, port against JAX on the same prompts:
  every mask bit that differs has a low-res logit within 1e-4 of the
  threshold 0, and every area count that differs is within the number of
  that slab's x4 interpolants lying within 1e-4 of it, so a flip shows its
  cause (at logits of this scale a few of the ~10^7 interpolants do lie
  that close).  Random weights cannot segment, so the filters that test a mask against
  its prompt are off (``stability_threshold`` 0, ``filter_edge_points``
  off), as in the JAX package's own tests of its real predictor.
- ``convert.load_npz_tree`` on ``.npz`` files written as
  ``convert_checkpoints.py`` writes them, and ``run_sfm``'s
  ``--sam-ckpt``/``--nnet-ckpt`` over 4 frames of odometry on the CPU
  through ``build_frontend`` (bf16 SAM); the builders turn TF32 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.data.synthetic import PlanesSequence as JPlanes
from super_primitive_tpu.frontend import process_frame as jpf
from super_primitive_tpu.nets import convert as jconvert
from super_primitive_tpu.nets.nnet import predict_normals as j_normals
from super_primitive_tpu.nets.sam import image_encoder as jie
from super_primitive_tpu.nets.sam.predictor import SamPredictor as JPredictor
from super_primitive_tpu.nets.synth import synth_nnet_state_dict, synth_sam_state_dict
from super_primitive_tpu_torch import convert as tconvert
from super_primitive_tpu_torch import run_sfm as trun
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.frontend import process_frame as tpf
from super_primitive_tpu_torch.nets import nnet as tnnet
from super_primitive_tpu_torch.nets.sam import image_encoder as tie
from super_primitive_tpu_torch.nets.sam import predictor as tp
from super_primitive_tpu_torch.utils import timing

TINY_1024 = dict(img_size=1024, embed_dim=32, depth=2, num_heads=2, window_size=14,
                 global_attn_indexes=(1,), out_chans=16)
NETWORK_DIM, GEO = (64, 96), (48, 64)
SAM = {"infer_resolution": [96, 128], "stability_threshold": 0.0, "filter_edge_points": False}


def frontend_cfg(load_config):
    return load_config({
        "save_path": "unused",
        "frontend": {
            "downsample_pow": 0, "num_pts": 16, "num_pts_active": 8,
            "normals": {"integration_shape": list(GEO), "network_dim": list(NETWORK_DIM)},
            "cg_max_iter": 150, "cg_tol": 1e-3, "check_for_depth_disc": True,
        },
        "sam_params": SAM,
    })


@pytest.fixture(scope="module")
def trees():
    sam_sd = synth_sam_state_dict(jie.ViTConfig(**TINY_1024))
    return (jconvert.convert_sam(sam_sd, depth=TINY_1024["depth"]),
            jconvert.convert_nnet(synth_nnet_state_dict()))


@pytest.fixture(scope="module")
def keyframes(trees):
    sam_tree, nnet_tree = trees
    frame = JPlanes(n_frames=1, H=96, W=128)[0]

    jsam = JPredictor(jax.tree.map(jnp.asarray, sam_tree), jie.ViTConfig(**TINY_1024))
    jnnet = jax.tree.map(jnp.asarray, nnet_tree)

    def j_normals_fn(img):
        return j_normals(jnnet, jnp.asarray(img), NETWORK_DIM, coarse_hw=GEO)

    j_normals_fn.accepts_uint8 = True
    jfp = jpf.FrontProcessor(frontend_cfg(jload_config), j_normals_fn,
                             jpf.wire_mask_predictor(jsam))
    kj = jfp.process_to_kf(frame["image"], frame["intrinsics"])

    tsam = tp.SamPredictor(tconvert.sam_from_flax(sam_tree), tie.ViTConfig(**TINY_1024),
                           device="cpu")
    model = tnnet.NNET().eval().requires_grad_(False)
    model.load_state_dict(tconvert.nnet_from_flax(nnet_tree))

    def t_normals_fn(img):
        return tnnet.predict_normals(model, img, NETWORK_DIM, coarse_hw=GEO)

    t_normals_fn.accepts_uint8 = True
    tfp = tpf.FrontProcessor(frontend_cfg(tload_config), t_normals_fn,
                             tpf.wire_mask_predictor(tsam), device="cpu")
    prompts = []
    decode = tsam._decode

    def spy(pts):
        prompts.append(pts.numpy().copy())
        return decode(pts)

    tsam._decode = spy
    counted, count = [], timing.count
    timing.count = lambda name, n=1: (counted.append(name), count(name, n))
    try:
        kt = tfp.process_to_kf(frame["image"], frame["intrinsics"])
    finally:
        del tsam._decode
        timing.count = count
    return kj, kt, (jsam, tsam, prompts, counted)


def test_keyframe_integer_outputs_identical(keyframes):
    kj, kt, _ = keyframes
    assert kt["regions"].shape[0] >= 1 and kt["regions"].any(axis=(1, 2)).all()
    assert np.array_equal(kt["regions"], kj["regions"])
    assert np.array_equal(kt["keypoints_rc"], kj["keypoints_rc"])
    np.testing.assert_array_equal(kt["K"], kj["K"])


def test_keyframe_logdepth_and_image(keyframes):
    kj, kt, _ = keyframes
    assert np.isfinite(kt["logdepth_perseg"]).all()
    np.testing.assert_allclose(kt["logdepth_perseg"], kj["logdepth_perseg"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(kt["image"], kj["image"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(kt["normals"], np.asarray(kj["normals"]), atol=1e-5, rtol=0)


def test_round_statistics_differ_only_at_threshold(keyframes):
    *_, (jsam, tsam, prompts, _) = keyframes
    assert len(prompts) == 2  # both prompt rounds, each decoded once
    h, w = tsam._input_hw
    for pts in prompts:
        t_masks, t_iou, _, t_area = tsam.predict_points_with_stats(pts, out_size=256)
        j_masks, j_iou, _, j_area = jsam.predict_points_with_stats(pts, out_size=256)
        lowres = tsam._decode(torch.from_numpy(pts))[0][:, 1:].double()
        assert lowres.shape[-1] == 256
        hs, ws = t_masks.shape[-2:]
        differ = t_masks != np.asarray(j_masks)
        assert (lowres[..., :hs, :ws].abs().numpy()[differ] <= 1e-4).all()
        d_area = np.abs(t_area.astype(np.int64) - np.asarray(j_area))
        for (b, m) in zip(*np.nonzero(d_area)):
            up = torch.nn.functional.interpolate(lowres[b, m][None, None], scale_factor=4,
                                                 mode="bilinear")[0, 0, :h, :w]
            assert d_area[b, m] <= int((up.abs() <= 1e-4).sum()), (b, m)
        assert rel_err(t_iou, j_iou) <= 3e-5


def test_the_real_predictor_makes_the_sam_frame(keyframes):
    """The keyframe hands the real predictor the image (``prepare_frame``);
    on the CPU the frame's plain version makes it, counted as made on the
    host."""
    *_, (_, tsam, _, counted) = keyframes
    assert isinstance(tsam._last_image, tp.SamFrame) and tsam._last_image.shape == (96, 128, 3)
    assert tsam._input_hw == (768, 1024)
    assert counted.count("sam_frame_on_host") == 1 and "sam_frame_on_card" not in counted


def rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def npz_files(trees, tmp_path_factory):
    """The trees as ``convert_checkpoints.py`` writes them."""
    root = tmp_path_factory.mktemp("ckpt")
    for name, tree in zip(("sam", "nnet"), trees):
        np.savez_compressed(root / f"{name}.npz", tree=np.asarray(tree, dtype=object))
    return root / "sam.npz", root / "nnet.npz"


def test_load_npz_tree(trees, npz_files):
    for path, tree, conv in zip(npz_files, trees,
                                (tconvert.sam_from_flax, tconvert.nnet_from_flax)):
        got, want = conv(tconvert.load_npz_tree(path)), conv(tree)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_build_frontend(trees):
    config = frontend_cfg(tload_config)
    fe = tpf.build_frontend(config, *trees, device="cpu")
    assert fe.normals_fn.accepts_uint8 and fe.mask_predict_fn.prepare_frame is not None
    predictor = fe.mask_predict_fn.predictor
    assert fe.mask_predict_fn.prepare_frame == predictor.prepare_frame
    assert predictor.compute_dtype == torch.bfloat16
    assert predictor.model.image_encoder.pos_embed.dtype == torch.bfloat16
    assert predictor.model.prompt_encoder.no_mask_embed.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="both required"):
        tpf.build_frontend(config, trees[0], None, device="cpu")


def test_frontend_turns_tf32_off(trees, monkeypatch):
    """``frontend_from_state_dicts`` turns TF32 off for cuBLAS and cuDNN,
    whoever builds the frontend (torch's default keeps cuDNN's on)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tpf.frontend_from_state_dicts(frontend_cfg(tload_config), tconvert.sam_from_flax(trees[0]),
                                  tconvert.nnet_from_flax(trees[1]), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


ODOM_YAML = """
save_path: {save}
window_size: 3
dataset: {{type: planes, path: linear}}
frontend:
  downsample_pow: 0
  num_pts: 16
  num_pts_active: 8
  normals: {{integration_shape: [48, 64], network_dim: [64, 96]}}
  cg_max_iter: 100
  cg_tol: 0.001
  check_for_depth_disc: true
sam_params: {{infer_resolution: [96, 128], stability_threshold: 0.0, filter_edge_points: false}}
alignment:
  mono_init: true
  init_frames: 3
  mapping: {{supp_every_n: 3, init_steps: 20, steps: 10, continual_steps: 2}}
  track: {{pyramid_min: 0, pyramid_max: 2, steps: [0, 20]}}
"""


def test_run_sfm_checkpoints_odometry(npz_files, tmp_path, capsys):
    """``run_sfm --sam-ckpt --nnet-ckpt --odom`` over 4 frames on the CPU
    through the real-net frontend (bf16 SAM): it completes and writes a
    keyframe trajectory of finite poses."""
    cfg = tmp_path / "odom.yaml"
    cfg.write_text(ODOM_YAML.format(save=tmp_path / "out"))
    sam, nnet = npz_files
    trun.main(["--config", str(cfg), "--device", "cpu", "--odom", "--max-frames", "4",
               "--sam-ckpt", str(sam), "--nnet-ckpt", str(nnet)])
    out = capsys.readouterr().out
    assert "[kf] added" in out and "artifacts in" in out
    traj = np.loadtxt(tmp_path / "out" / "converted_tum_traj.txt", ndmin=2)
    assert traj.shape[0] >= 1 and traj.shape[1] == 8 and np.isfinite(traj).all()
