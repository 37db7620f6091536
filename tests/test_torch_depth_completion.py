"""Depth completion of the PyTorch port against the JAX package (CPU).

- ``render_depth_avg``, ``fill_single_griddata`` and the VOID metrics
  against JAX, relative 1e-6;
- ``segment_based_depth_reinit`` in both modes with ``return_info``, on a
  sparse and on a dense estimate, exact;
- ``DepthCompletion`` on ``PatchSegmentFrontend`` against JAX, with and
  without the loose rerun: the same calls, depth within 1e-6 relative;
- ``DepthCompletion`` on the structured fake ``FrontProcessor`` (device
  SAM selection, the depth split, the loose rerun forced) at 96x128
  against JAX: each pass's regions and the invalid mask identical, depth
  within 2e-3 relative (the frontend tests hold log-depth to 1e-3);
- ``predict_points_with_stats`` decoded in chunks of 128 equal to one
  decode of all prompts, at B > 128, on the fake and on a tiny real SAM;
- the port's checkpoint converters (``convert.sam_to_flax``,
  ``nnet_to_flax``) equal to JAX's and inverse to ``sam_from_flax`` /
  ``nnet_from_flax``;
- ``python -m super_primitive_tpu_torch.evaluate_void --stub-frontend
  --device cpu`` on a tiny VOID tree prints the root ``evaluate_void.py``'s
  tables within 1e-3.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.data.synthetic import PlanesSequence as JPlanes
from super_primitive_tpu.depth_completion import completion as jc
from super_primitive_tpu.depth_completion import fill_in as jfill
from super_primitive_tpu.depth_completion import metrics as jm
from super_primitive_tpu.frontend.fakes import DeviceFakeSAM as JSam
from super_primitive_tpu.frontend.fakes import StructuredFakeFrontend as JFrontend
from super_primitive_tpu.frontend.stub import PatchSegmentFrontend as JPatch
from super_primitive_tpu.nets import convert as jconvert
from super_primitive_tpu.odometry import depth_init as jdi
from super_primitive_tpu_torch import convert as tconvert
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.data.synthetic import PlanesSequence as TPlanes
from super_primitive_tpu_torch.depth_completion import completion as tc
from super_primitive_tpu_torch.depth_completion import fill_in as tfill
from super_primitive_tpu_torch.depth_completion import metrics as tm
from super_primitive_tpu_torch.eval.dataset_trees import write_void_tree
from super_primitive_tpu_torch.frontend.fakes import DeviceFakeSAM as TSam
from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend as TFrontend
from super_primitive_tpu_torch.frontend.stub import PatchSegmentFrontend as TPatch
from super_primitive_tpu_torch.nets import synth
from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_TINY_TEST
from super_primitive_tpu_torch.nets.sam import predictor as tpredictor
from super_primitive_tpu_torch.nets.sam.predictor import SamPredictor
from super_primitive_tpu_torch.odometry import depth_init as tdi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_case(H=40, W=52, n_sparse=25, seed=0):
    """The JAX package's completion case (tests/test_depth_completion.py)."""
    r = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    gt = (1.5 + 0.3 * np.sin(u * 0.1) + 0.2 * np.cos(v * 0.13)).astype(np.float32)
    sparse = np.zeros((H, W), np.float32)
    idx = r.choice(H * W, n_sparse, replace=False)
    sparse.reshape(-1)[idx] = gt.reshape(-1)[idx]
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]])
    return gt, sparse, K


def test_render_depth_avg():
    r = np.random.default_rng(0)
    d = r.uniform(0.5, 4.0, (7, 20, 30)).astype(np.float32)
    d[r.random(d.shape) < 0.6] = -1.0
    d[:, :3] = -1.0  # pixels no segment covers
    got = tc.render_depth_avg(torch.from_numpy(d))
    want = jc.render_depth_avg(d)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert want[1][:3].all() and not want[1].all()
    empty = tc.render_depth_avg(torch.zeros((0, 5, 6)))
    np.testing.assert_array_equal(empty[0].numpy(), jc.render_depth_avg(np.zeros((0, 5, 6)))[0])
    assert empty[1].all()


def test_fill_single_griddata():
    gt, _, _ = make_case()
    invalid = np.zeros_like(gt, bool)
    invalid[10:20, 10:20] = True
    invalid[:, :4] = True  # outside the hull: the nearest fill
    depth = np.where(invalid, 0, gt)
    got = tfill.fill_single_griddata(depth, invalid)
    np.testing.assert_allclose(got, jfill.fill_single_griddata(depth, invalid), rtol=1e-6)
    assert np.isfinite(got).all()


def test_metrics():
    r = np.random.default_rng(1)
    est = r.uniform(1.0, 3.0, (30, 40))
    tgt = est + r.normal(0, 0.1, est.shape)
    valid = r.random(est.shape) < 0.7
    a, b = tm.ErrorMetrics(), jm.ErrorMetrics()
    a.compute(est, tgt, valid)
    b.compute(est, tgt, valid)
    avg_a, avg_b = tm.ErrorMetricsAverager(), jm.ErrorMetricsAverager()
    for m_a, m_b in ((a, b), (a, b)):
        avg_a.accumulate(m_a)
        avg_b.accumulate(m_b)
    avg_a.average()
    avg_b.average()
    for k, v in avg_b.as_dict().items():
        np.testing.assert_allclose(avg_a.as_dict()[k], v, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=1e-6, err_msg=k)
    for mult in (False, True):
        da, db = tm.delta_metric(est, tgt, mult), jm.delta_metric(est, tgt, mult)
        assert da.keys() == db.keys()
        for k in db:
            np.testing.assert_allclose(da[k], db[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["median", "mean"])
@pytest.mark.parametrize("dense", [False, True])
def test_segment_based_depth_reinit(mode, dense):
    r = np.random.default_rng(2)
    N, H, W = 9, 24, 32
    regions = r.random((N, H, W)) < 0.3
    regions[4] = False
    regions[4, 0, 0] = True  # a segment no estimate reaches
    logdepth = (r.normal(0.5, 0.2, (N, H, W)) * regions).astype(np.float32)
    est = r.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    if not dense:
        est[r.random((H, W)) > 0.05] = 0.0
    est[0, 0] = 0.0
    kp_rc = np.stack([r.integers(0, H, N), r.integers(0, W, N)], axis=1)
    got = tdi.segment_based_depth_reinit(est, regions, logdepth, kp_rc, mode=mode,
                                         return_info=True)
    want = jdi.segment_based_depth_reinit(est, regions, logdepth, kp_rc, mode=mode,
                                          return_info=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not want[1][4] and want[1].sum() >= 5
    np.testing.assert_array_equal(
        tdi.segment_based_depth_reinit(est, regions, logdepth, kp_rc, mode=mode), want[0])


@pytest.mark.parametrize("n_sparse, patch, calls", [(200, 9, [False]), (2, 5, [False, True])])
def test_completion_on_patch_stub(n_sparse, patch, calls):
    gt, sparse, K = make_case(n_sparse=n_sparse)
    img = np.zeros((*gt.shape, 3), np.uint8)
    out = []
    for fe, dc_cls in ((TPatch(gt, patch=patch, device="cpu"), tc.DepthCompletion),
                       (JPatch(gt, patch=patch), jc.DepthCompletion)):
        dc = dc_cls(fe)
        depth, invalid = dc.depth_completion(img, K, sparse)
        assert fe.calls == calls
        out.append((depth, invalid))
        if isinstance(fe, TPatch):
            dc_segments = dc.segments
    assert dc_segments == [(n_sparse, n_sparse)] * len(calls)
    (dt, it), (dj, ij) = out
    assert dt.dtype == dj.dtype == np.float32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=0)
    np.testing.assert_allclose(dt[~it], gt[~it], rtol=1e-5)


def test_patch_stub_observe():
    gt, sparse, K = make_case()
    gt_inf = np.where(gt > 1.6, np.inf, gt)
    kps = 2.0 * np.stack(np.nonzero(sparse), 1).astype(np.float32) / (np.asarray(gt.shape) - 1) - 1
    a, b = TPatch(), JPatch()
    a.observe({"gt_depth": gt_inf})
    b.observe({"gt_depth": gt_inf})
    for loose in (False, True):
        ka = a.process_to_kf(np.zeros((*gt.shape, 3)), K, keypoints=kps, loose=loose)
        kb = b.process_to_kf(np.zeros((*gt.shape, 3)), K, keypoints=kps, loose=loose)
        for k in kb:
            np.testing.assert_array_equal(ka[k], kb[k], err_msg=k)
    with pytest.raises(RuntimeError, match="observe"):
        TPatch().process_to_kf(None, K, keypoints=kps)


def test_completion_runs_on_the_frontends_device():
    """The dense part runs on the frontend's ``device``; a frontend without
    one is refused, not sent to the CPU."""
    gt, sparse, K = make_case(n_sparse=50)
    img = np.zeros((*gt.shape, 3), np.uint8)
    r, c = np.nonzero(sparse)
    kps = 2.0 * np.stack([r, c], 1).astype(np.float32) / (np.asarray(gt.shape) - 1) - 1
    depth, invalid = tc.infer_depth(TPatch(gt, device="cpu"), img, kps, K, sparse)
    assert depth.device == invalid.device == torch.device("cpu")
    assert TPatch(gt).device == torch.device("cuda")

    class NoDevice:
        process_to_kf = staticmethod(TPatch(gt, device="cpu").process_to_kf)

    with pytest.raises(AttributeError, match="device"):
        tc.DepthCompletion(NoDevice()).depth_completion(img, K, sparse)


def completion_cfg(load_config):
    """The VOID config's SAM and split settings at 96x128 frames (CG cut to
    300 iterations at 1e-3 for the CPU)."""
    return load_config({
        "save_path": "unused",
        "frontend": {
            "downsample_pow": 0, "num_pts": 100, "num_pts_active": 16,
            "normals": {"integration_shape": [48, 64], "network_dim": [96, 128]},
            "cg_max_iter": 300, "cg_tol": 1e-3, "check_for_depth_disc": True,
            "depth_disc_params": {"filter_size": 3, "depth_threshold": 0.1,
                                  "area_keep_ratio": 0.001},
        },
        "sam_params": {"infer_resolution": [192, 256], "select_smallest": True, "nms": True,
                       "box_nms_thresh": 0.8, "iou_threshold": 0.0,
                       "stability_threshold": 0.9, "filter_edge_points": False},
    })


def test_completion_on_fake_frontend():
    seq = JPlanes(n_frames=1, H=96, W=128)
    frame = seq[0]
    r = np.random.default_rng(4)
    sparse = np.zeros((96, 128), np.float32)
    pick = r.choice(96 * 128, 40, replace=False)
    sparse.reshape(-1)[pick] = np.round(frame["depth"].reshape(-1)[pick] * 256) / 256
    out, kfs = {}, {}
    for name, cls, load, dc in (("torch", TFrontend, tload_config, tc),
                                ("jax", JFrontend, jload_config, jc)):
        kw = {"device": "cpu"} if name == "torch" else {}
        fe = cls(completion_cfg(load), seed=0, n_cells=24, device_sam=True, **kw)
        fe.observe(frame)
        seen = kfs.setdefault(name, [])
        process = fe.process_to_kf

        def spy(*a, process=process, seen=seen, **k):
            kf = process(*a, **k)
            seen.append(kf)
            return kf

        fe.process_to_kf = spy
        out[name] = dc.DepthCompletion(fe, invalid_ratio_thresh=0.0).depth_completion(
            frame["image"], frame["intrinsics"], sparse)
    assert len(kfs["torch"]) == len(kfs["jax"]) == 2  # the loose rerun ran
    for kt, kj in zip(kfs["torch"], kfs["jax"]):
        assert kt["regions"].shape[0] >= 5
        np.testing.assert_array_equal(kt["regions"], kj["regions"])
        np.testing.assert_array_equal(kt["keypoints_rc"], kj["keypoints_rc"])
    assert kfs["torch"][1]["regions"].shape[0] > kfs["torch"][0]["regions"].shape[0]
    (dt, it), (dj, ij) = out["torch"], out["jax"]
    np.testing.assert_array_equal(it, ij)
    assert (~it).mean() > 0.5
    np.testing.assert_allclose(dt, dj, rtol=2e-3, atol=0)


def test_stats_chunks_equal_one_decode(monkeypatch):
    """B = 130 > 128: the fake in chunks against one decode and against JAX
    (exact), and a tiny real SAM in chunks against one decode (exact)."""
    img = np.zeros((96, 128, 3), np.uint8)
    t, j = TSam(n_cells=24, seed=0, device="cpu"), JSam(n_cells=24, seed=0)
    t.set_image(img)
    j.set_image(img)
    xy = np.random.default_rng(5).uniform(0, [1023, 767], (130, 2)).round().astype(np.float32)
    chunked = t.predict_points_with_stats(xy)
    with monkeypatch.context() as m:
        m.setattr(tpredictor, "STATS_CHUNK", 130)
        whole = t.predict_points_with_stats(xy)
    for a, b, c in zip(chunked, whole, j.predict_points_with_stats(xy)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert chunked[0].shape == (130, 3, 192, 256)

    p = SamPredictor(synth.scale_like_trained(synth.synth_sam_state_dict(VIT_TINY_TEST)),
                     VIT_TINY_TEST, device="cpu")
    p.set_image(np.random.default_rng(6).integers(0, 256, (48, 64, 3), np.uint8))
    xy = np.random.default_rng(7).uniform(0, [63, 47], (300, 2)).round().astype(np.float32)
    chunked = p.predict_points_with_stats(xy, out_size=16)
    monkeypatch.setattr(tpredictor, "STATS_CHUNK", 300)
    for a, b in zip(chunked, p.predict_points_with_stats(xy, out_size=16)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_converters():
    sd = synth.synth_sam_state_dict(VIT_TINY_TEST)
    tree = tconvert.sam_to_flax(sd, depth=VIT_TINY_TEST.depth)
    want = jconvert.convert_sam(sd, depth=VIT_TINY_TEST.depth)
    flat_t, flat_j = flatten(tree), flatten(want)
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k], v, err_msg=k)
    back = tconvert.sam_from_flax(tree)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    nsd = synth.synth_nnet_state_dict()
    tree = tconvert.nnet_to_flax(nsd)
    flat_t, flat_j = flatten(tree), flatten(jconvert.convert_nnet(nsd))
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k], v, err_msg=k)
    back, want = tconvert.nnet_from_flax(tree), tconvert.nnet_state_dict(nsd)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def tables(stdout: str) -> dict:
    """{(table, metric): value} and the validity-rate line of an
    evaluate_void run's output."""
    out, table = {}, None
    for line in stdout.splitlines():
        if line.startswith("=== "):
            table = line.split()[1]
        elif table and ":" in line and line.startswith("  "):
            k, v = line.split(":")
            out[(table, k.strip())] = float(v)
        elif line.startswith("validity rate:"):
            words = line.split()
            for name, value in zip(words[2::2], words[3::2]):
                out[("validity", name)] = float(value)
    return out


def test_evaluate_void_cli(tmp_path):
    root = write_void_tree(tmp_path / "void", TPlanes(n_frames=2, H=96, W=128), 2,
                           n_sparse=60, seed=1)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for name, cmd in (
            ("torch", [sys.executable, "-m", "super_primitive_tpu_torch.evaluate_void",
                       "--device", "cpu"]),
            ("jax", [sys.executable, os.path.join(REPO, "evaluate_void.py")])):
        proc = subprocess.run(cmd + ["--dataset", str(root), "--stub-frontend"], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[name] = tables(proc.stdout)
        runs.setdefault("stdout", {})[name] = proc.stdout
    got, want = runs["torch"], runs["jax"]
    assert len(want) == 16 and got.keys() == want.keys()
    # the tables print three decimals: values within the 1e-3 bound may
    # print one unit apart, whose difference as floats is a hair above 1e-3
    for k, v in want.items():
        assert round(abs(got[k] - v), 9) <= 1e-3, (k, got[k], v, runs["stdout"])
    assert want[("valid-only", "rmse")] < 20.0


def test_cpu_entry_points_settle_exp(monkeypatch):
    """``require_device("cpu")``, which every CPU entry point takes, runs a
    one-element ``exp`` before any large one (``numerics.settle_cpu_exp``);
    the card's path does not."""
    from super_primitive_tpu_torch import run_sfm

    calls = []
    monkeypatch.setattr(run_sfm, "settle_cpu_exp", lambda: calls.append(1))
    assert run_sfm.require_device("cpu") == torch.device("cpu") and calls == [1]
    if torch.cuda.is_available():
        run_sfm.require_device("cuda")
        assert calls == [1]


def test_evaluate_void_needs_a_card_or_cpu(tmp_path):
    """The CLI runs on the card by default and raises without one; a
    frontend must be named."""
    from super_primitive_tpu_torch import evaluate_void

    root = write_void_tree(tmp_path / "void", TPlanes(n_frames=1, H=48, W=64), 1, n_sparse=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate_void.main(["--dataset", str(root), "--stub-frontend"])
    with pytest.raises(ValueError, match="--stub-frontend"):
        evaluate_void.main(["--dataset", str(root), "--device", "cpu"])


def test_evaluate_void_real_nets_cpu(tmp_path, capsys):
    """``evaluate_void --sam-ckpt --nnet-ckpt --device cpu`` on ``.npz``
    trees the port's converters write (a ViT of SAM's 1024 input, two
    narrow blocks; the B5 NNET), over one 96x128 image; random weights
    leave most pixels invalid, so the loose rerun runs."""
    import yaml

    from super_primitive_tpu_torch import evaluate_void
    from super_primitive_tpu_torch.nets.sam.image_encoder import ViTConfig

    vit = ViTConfig(img_size=1024, embed_dim=32, depth=2, num_heads=2, window_size=14,
                    global_attn_indexes=(1,), out_chans=16)
    tconvert.save_npz_tree(tmp_path / "sam.npz", tconvert.sam_to_flax(
        synth.scale_like_trained(synth.synth_sam_state_dict(vit)), depth=vit.depth))
    tconvert.save_npz_tree(tmp_path / "nnet.npz",
                           tconvert.nnet_to_flax(synth.synth_nnet_state_dict()))
    root = write_void_tree(tmp_path / "void", TPlanes(n_frames=1, H=96, W=128), 1,
                           n_sparse=16, seed=2)
    cfg = yaml.safe_load(open(os.path.join(REPO, "super_primitive_tpu_torch", "configs",
                                           "void_dataset.yaml")))
    cfg["frontend"].update(normals={"integration_shape": [48, 64], "network_dim": [64, 96]},
                           cg_max_iter=40, cg_tol=1e-3)
    # random weights: no candidate is stable at the config's 0.9
    cfg["sam_params"].update(infer_resolution=[96, 128], stability_threshold=0.0)
    path = tmp_path / "void.yaml"
    path.write_text(yaml.safe_dump(cfg))
    res = evaluate_void.main(["--dataset", str(root), "--config", str(path), "--device", "cpu",
                              "--sam-ckpt", str(tmp_path / "sam.npz"),
                              "--nnet-ckpt", str(tmp_path / "nnet.npz")])
    out = capsys.readouterr().out
    assert "=== filled over 1 samples ===" in out and "validity rate:" in out
    image = res["images"][0]
    assert image["sparse_points"] == 16 and 0 < image["validity_rate"] <= 1
    assert "loose_rerun" in image["stage_s"] and "sam_round1" in image["stage_s"]
    assert len(image["segments"]) == 2 and all(n >= max(v, 1) for n, v in image["segments"])
    # both passes' counts: the keyframes' segments, each pass's prompts in two rounds
    counters = image["counters"]
    assert counters["segments"] == sum(n for n, _ in image["segments"])
    assert counters["prompts_decoded"] >= 2 * 16 and counters["host_reads"] > 0
    assert res["completion"].frontend.device.type == "cpu"
