"""The run artifacts and the live viewer of the PyTorch port against the JAX
package (CPU).

Inputs are made with numpy from fixed seeds and go through both packages.
Bounds:

- ``save_ply``: the same bytes as JAX's (float and uint8 colours, none);
  ``keyframe_pointcloud`` within 1e-6;
- ``save_residual_png``: decoded by the port's reader, the same pixels as
  the PNG JAX writes through OpenCV's inferno colour map;
- ``save_trajectory_plot``: a PNG the reader decodes, holding each
  trajectory's colour;
- ``save_html_viewer``: the same bytes as JAX's on the same clouds (with
  segment ids), trajectories and replay frames;
- ``LiveViz``: the same ``live.html`` and ``live.json`` as JAX's; the pause
  marker blocks ``checkpoint``, a stale marker is cleared at start, and the
  server toggles the marker on ``POST /pause`` with ``Cache-Control:
  no-store`` (``tests/test_live_viz.py``'s patterns, on localhost);
- the Adam two-frame solve in chunks of 7 iterations (not a divisor of
  20) equals the unchunked solve bit for bit, and its callback sees the
  (level, iterations done) sequence JAX's does;
- ``run_sfm.main(..., "--device", "cpu")`` at 96x128 writes the two-frame
  artifacts (``src_pointcloud.ply``, ``viewer.html``, ``--live-viz``'s
  ``live.json``) and the odometry ones (``viewer.html``,
  ``trajectory.png``, the TUM files, a ``live.json`` whose ``seq`` counts
  the frames); ``convert_traj_to_tum`` on that run writes the lines the JAX
  exporter writes for the same trajectory.
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_odometry import PlaneSequence

from super_primitive_tpu import keyframe as jkf
from super_primitive_tpu.odometry import io as jio
from super_primitive_tpu.solve import two_frame as jtf
from super_primitive_tpu.viz import export as jexport
from super_primitive_tpu.viz import live as jlive
from super_primitive_tpu.viz import viewer as jviewer
from super_primitive_tpu_torch import convert_traj_to_tum as tconvert
from super_primitive_tpu_torch import keyframe as tkf
from super_primitive_tpu_torch import run_sfm as trun
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.data.image_io import read_png
from super_primitive_tpu_torch.frontend.stub import GridSegmentFrontend as TGrid
from super_primitive_tpu_torch.odometry import io as tio
from super_primitive_tpu_torch.solve import two_frame as ttf
from super_primitive_tpu_torch.viz import export as texport
from super_primitive_tpu_torch.viz import live as tlive
from super_primitive_tpu_torch.viz import viewer as tviewer
from super_primitive_tpu_torch.viz.serve import serve


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops (as in ``test_torch_odometry_gn.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rng(seed=0):
    return np.random.default_rng(seed)


def clouds(seed=0):
    r = rng(seed)
    pts = r.normal(size=(60, 3)).astype(np.float32)
    return {
        "a": (pts, r.uniform(size=(60, 3)).astype(np.float32), r.integers(0, 9, 60)),
        "b": (pts[:20] * 2, None),
        "c": (pts[:5], r.integers(0, 255, (5, 3)).astype(np.uint8)),
    }


@pytest.mark.parametrize("colors", ["float", "uint8", "none"])
def test_save_ply_bytes(tmp_path, colors):
    r = rng(1)
    pts = r.normal(size=(50, 3))
    col = {"float": r.uniform(-0.1, 1.1, (50, 3)),
           "uint8": r.integers(0, 256, (50, 3)).astype(np.uint8), "none": None}[colors]
    a = texport.save_ply(str(tmp_path / "t" / "c.ply"), pts, col)
    b = jexport.save_ply(str(tmp_path / "j" / "c.ply"), pts, col)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_keyframe_pointcloud():
    r = rng(2)
    uv = r.uniform(0, 64, (200, 2)).astype(np.float32)
    z = r.uniform(0.5, 4, 200).astype(np.float32)
    K = np.array([[50.0, 0, 32], [0, 52.0, 24], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.2, 0.3]
    valid = r.uniform(size=200) > 0.3
    col = r.uniform(size=(200, 3))
    pt, ct = texport.keyframe_pointcloud(uv, z, K, T, colors=col, valid=valid)
    pj, cj = jexport.keyframe_pointcloud(uv, z, K, T, colors=col, valid=valid)
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("shape", [(32, 48, 3), (20, 30)])
def test_residual_png_pixels(tmp_path, shape):
    img = rng(3).uniform(-0.3, 0.3, shape)
    a = texport.save_residual_png(str(tmp_path / "t.png"), img)
    b = jexport.save_residual_png(str(tmp_path / "j.png"), img)
    got, want = read_png(a), read_png(b)
    assert got.shape == shape[:2] + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_trajectory_plot(tmp_path):
    r = rng(4)
    trajs = {}
    for name in ("estimate", "gt", "other"):
        poses = {}
        for i in range(6):
            T = np.eye(4)
            T[:3, 3] = r.normal(size=3) * 0.3 + i * 0.05
            poses[str(i)] = T
        trajs[name] = poses
    fp = texport.save_trajectory_plot(str(tmp_path / "p" / "traj.png"), trajs)
    img = read_png(fp)
    assert img.shape == (600, 600, 3)
    for color in texport.TRAJECTORY_COLORS[:3]:
        # the swatch (200 px) and the polyline
        assert (img == color).all(-1).sum() > 200
    assert not (img == texport.TRAJECTORY_COLORS[3]).all(-1).any()


def test_html_viewer_bytes(tmp_path):
    c = clouds()
    trajs = {"track": rng(5).normal(size=(7, 3))}
    frames = [{"label": "level 0 iter 7", "loss": 0.5, "clouds": {"a": c["a"]}},
              {"label": "level 0 iter 14", "clouds": {"b": c["b"]}}]
    kw = dict(trajectories=trajs, frames=frames, title="t")
    a = tviewer.save_html_viewer(str(tmp_path / "t.html"), c, **kw)
    b = jviewer.save_html_viewer(str(tmp_path / "j.html"), c, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_liveviz_snapshots_equal_jax(tmp_path):
    ours, theirs = tmp_path / "t", tmp_path / "j"
    lt, lj = tlive.LiveViz(str(ours), title="t"), jlive.LiveViz(str(theirs), title="t")
    c = {k: v[:2] for k, v in clouds().items()}
    for lv in (lt, lj):
        lv.update(c, label="frame 1", loss=0.5)
        lv.update(c, trajectories={"track": c["a"][0][:5]}, label="frame 2")
    assert (ours / tlive.LIVE_HTML).read_bytes() == (theirs / jlive.LIVE_HTML).read_bytes()
    d = json.loads((ours / tlive.LIVE_JSON).read_text())
    assert d == json.loads((theirs / jlive.LIVE_JSON).read_text())
    assert d["seq"] == 2 and d["loss"] is None and d["trajs"]["track"]["n"] == 5


def test_pause_checkpoint_blocks(tmp_path):
    lv = tlive.LiveViz(str(tmp_path), poll_s=0.05)
    marker = tmp_path / tlive.PAUSE_MARKER
    marker.touch()
    t = threading.Timer(0.3, marker.unlink)
    t.start()
    assert lv.checkpoint() >= 0.25
    assert lv.checkpoint() < 0.05


def test_stale_marker_cleared_on_init(tmp_path):
    (tmp_path / tlive.PAUSE_MARKER).touch()
    tlive.LiveViz(str(tmp_path))
    assert not (tmp_path / tlive.PAUSE_MARKER).exists()


def test_serve_get_and_pause_toggle(tmp_path):
    lv = tlive.LiveViz(str(tmp_path))
    lv.update({"c": (np.zeros((3, 3), np.float32), None)})
    httpd = serve(str(tmp_path), port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/{tlive.LIVE_JSON}") as r:
            assert r.headers["Cache-Control"] == "no-store"
            assert json.loads(r.read())["clouds"]["c"]["n"] == 3
        with urllib.request.urlopen(f"{base}/{tlive.LIVE_HTML}") as r:
            assert b"webgl" in r.read()
        req = urllib.request.Request(f"{base}/pause", method="POST")
        with urllib.request.urlopen(req) as r:
            assert json.loads(r.read())["paused"] is True
        assert (tmp_path / tlive.PAUSE_MARKER).exists()
        with urllib.request.urlopen(req) as r:
            assert json.loads(r.read())["paused"] is False
        assert not (tmp_path / tlive.PAUSE_MARKER).exists()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join()


def stub_problem():
    """A two-frame problem on the 48x64 plane sequence through the grid
    stub: host geometry, depth seeds and a perturbed pose."""
    seq = PlaneSequence(n_frames=5)
    fe = TGrid(rows=4, cols=5)
    fe.observe(seq[0])
    kf = fe.process_to_kf(seq[0]["image"], seq[0]["intrinsics"])
    supp = fe.process_to_supp_kf(seq[4]["image"], seq[4]["intrinsics"])
    kp = 2.0 * kf["keypoints_rc"] / (np.asarray(kf["regions"].shape[1:]) - 1) - 1.0
    ld0 = np.log(rng(43).uniform(2.0, 4.0, len(kp))).astype(np.float32)
    T_init = (np.linalg.inv(seq[4]["T"]) @ seq[0]["T"]).astype(np.float32)
    T_init[:3, 3] += 0.01
    return kf, supp, kp, ld0, T_init


def test_chunked_adam_solve_equals_unchunked():
    kf, supp, kp, ld0, T_init = stub_problem()
    cfg = ttf.TwoFrameConfig(num_iters=20)

    def torch_solve(**snap):
        geo = tkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"], device="cpu")
        bundle = tkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"], device="cpu")
        mk = lambda im, g=None: tkf.KeyFrame(  # noqa: E731
            image=torch.from_numpy(im["image"]), K=torch.from_numpy(im["K"]),
            K_img=torch.from_numpy(im["K"]), geo=g)
        sp = tkf.keyframe_pyramid(mk(kf, geo), 0, 2, bundle=bundle)
        tp = tkf.keyframe_pyramid(mk(supp), 0, 2)
        return ttf.solve_two_frame(sp, [tp], torch.from_numpy(T_init)[None],
                                   torch.from_numpy(ld0), cfg, **snap)

    seen = []
    chunk_losses = []

    def cb(level, done, params, losses):
        seen.append((level, done))
        chunk_losses.append(losses.clone())
        assert params.kp_logdepth.shape == (len(kp),)

    P0, L0, H0 = torch_solve()
    P1, L1, H1 = torch_solve(snapshot_cb=cb, snapshot_every=7)
    assert torch.equal(P0, P1) and torch.equal(L0, L1)
    assert len(H0) == len(H1) == 2 and all(torch.equal(a, b) for a, b in zip(H0, H1))
    assert torch.equal(torch.cat(chunk_losses), torch.cat(H1))

    geo = jkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"])
    bundle = jkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"])
    mk = lambda im, g=None: jkf.KeyFrame(  # noqa: E731
        image=jnp.asarray(im["image"]), K=jnp.asarray(im["K"]), K_img=jnp.asarray(im["K"]), geo=g)
    jseen = []
    jtf.solve_two_frame(
        jkf.keyframe_pyramid(mk(kf, geo), 0, 2, bundle=bundle),
        [jkf.keyframe_pyramid(mk(supp), 0, 2)],
        jnp.asarray(T_init)[None], jnp.asarray(ld0), jtf.TwoFrameConfig(num_iters=20),
        snapshot_cb=lambda level, done, p, l: jseen.append((level, done)), snapshot_every=7)
    assert seen == jseen == [(0, 7), (0, 14), (0, 20), (1, 7), (1, 14), (1, 20)]


def small_config(path, save_path, odom):
    seq_cfg = {"type": "planes", "path": "linear", "source_id": 0, "target_id": 4}
    cfg = {
        "save_path": str(save_path),
        "window_size": 4,
        "dataset": seq_cfg,
        "frontend": {"downsample_pow": 0, "num_pts": 48, "num_pts_active": 16,
                     "normals": {"integration_shape": [48, 64], "network_dim": [96, 128]},
                     "cg_max_iter": 150, "cg_tol": 1e-3, "check_for_depth_disc": odom},
        "sam_params": {"infer_resolution": [96, 128]},
        # two-frame SfM solves at the coarser level only (48x64)
        "alignment": {"pyramid_min": 1, "pyramid_max": 2, "mono_init": True, "init_frames": 3,
                      "track": {"pyramid_min": 0, "pyramid_max": 2, "steps": [0, 40]},
                      "mapping": {"init_steps": 30, "steps": 20, "continual_steps": 3}},
        "kf": {"depth_validity_ratio": 0.60, "translation_thresh": 0.04},
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_run_sfm_artifacts_and_live_viz(tmp_path, capsys):
    sfm = small_config(tmp_path / "sfm.yaml", tmp_path / "sfm", odom=False)
    trun.main(["--config", str(sfm), "--fake-frontend", "--device", "cpu",
               "--live-viz", str(tmp_path / "live_sfm"), "--live-every", "200"])
    out = tmp_path / "sfm"
    ply = (out / "src_pointcloud.ply").read_text().splitlines()
    n = int(ply[2].split()[-1])
    assert ply[0] == "ply" and len(ply) == 7 + n and n > 100
    html = (out / "viewer.html").read_text()
    assert '"seg": ' in html and "two-frame SfM result" in html
    live = json.loads((tmp_path / "live_sfm" / tlive.LIVE_JSON).read_text())
    # TwoFrameConfig's 500 iterations at its one level, every 200
    assert live["seq"] == 3 and live["clouds"]["src"]["n"] == n
    assert np.load(out / "two_frame_result.npz")["pose"].shape == (4, 4)

    frames = 10
    odom = small_config(tmp_path / "odom.yaml", tmp_path / "odom", odom=True)
    trun.main(["--config", str(odom), "--odom", "--fake-frontend", "--device", "cpu",
               "--max-frames", str(frames), "--live-viz", str(tmp_path / "live_odom")])
    text = capsys.readouterr().out
    assert "ATE RMSE (Sim3)" in text
    out = tmp_path / "odom"
    live = json.loads((tmp_path / "live_odom" / tlive.LIVE_JSON).read_text())
    assert live["seq"] == frames - 1 and live["trajs"]["track"]["n"] >= 2
    assert '"seg": ' in (out / "viewer.html").read_text()
    assert read_png(str(out / "trajectory.png")).shape == (600, 600, 3)
    ours = (out / "converted_tum_traj.txt").read_text()
    assert len(ours.splitlines()) >= 3

    # convert_traj_to_tum against the JAX exporter on the same trajectory
    (out / "converted_tum_traj.txt").unlink()
    (out / "converted_gt_tum_traj.txt").unlink()
    tconvert.main(["--run", str(out), "--config", str(odom)])
    traj = tio.load_trajectory(str(out / "traj" / "kf_traj_final.json"))
    seq = trun.load_dataset(tload_config(str(odom)), n_frames=frames)
    ts = {k: float(seq[int(k)]["timestamp"]) for k in traj}
    jio.export_tum_trajectory(traj, ts, str(tmp_path / "j_pred.txt"))
    jio.export_tum_trajectory({k: seq[int(k)]["T"] for k in traj}, ts, str(tmp_path / "j_gt.txt"))
    assert (out / "converted_tum_traj.txt").read_text() == (tmp_path / "j_pred.txt").read_text()
    assert (out / "converted_tum_traj.txt").read_text() == ours
    assert (out / "converted_gt_tum_traj.txt").read_text() == (tmp_path / "j_gt.txt").read_text()
