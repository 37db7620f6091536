"""The port's dataset layer against the JAX package's (CPU).

- ``data/image_io.read_png`` against ``cv2.imread`` on files OpenCV writes
  with each PNG filter and with its adaptive choice (8-bit gray, RGB,
  RGBA, 16-bit gray), exact; the files of the port's own writer
  (``eval/dataset_trees.write_png``) read back by OpenCV, exact; palette,
  interlaced, 4-bit and JPEG files raise;
- ``undistort_maps`` against ``cv2.initUndistortRectifyMap`` within 1e-3
  px, and the remap against ``cv2.undistort`` within the bounds the JAX
  package holds its native remap to (``tests/test_native_loader.py``: 2
  levels in the interior, 16 anywhere);
- ``TUMDataset``, ``TUMUndistortDataset``, ``ReplicaDataset`` (with
  ground-truth normals) and ``VoidDataset`` against the JAX loaders on tiny
  trees: images, depths, poses, K and masks exact, the undistorted image
  within the remap bounds;
- ``data.load_dataset`` and ``run_sfm.load_dataset`` dispatch;
- ``run_sfm --odom --fake-frontend --device cpu`` over a 3-frame TUM tree.
"""

import cv2
import numpy as np
import pytest

from super_primitive_tpu.data.replica import ReplicaDataset as JReplica
from super_primitive_tpu.data.tum import TUMDataset as JTUM
from super_primitive_tpu.data.tum import TUMUndistortDataset as JTUMUndistort
from super_primitive_tpu.data.void import VoidDataset as JVoid
from super_primitive_tpu_torch import run_sfm as trun
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.data import load_dataset
from super_primitive_tpu_torch.data.image_io import read_png, read_rgb
from super_primitive_tpu_torch.data.replica import ReplicaDataset
from super_primitive_tpu_torch.data.synthetic import PlanesSequence
from super_primitive_tpu_torch.data.tum import TUMDataset, TUMUndistortDataset
from super_primitive_tpu_torch.data.undistort import remap_bilinear, undistort_maps
from super_primitive_tpu_torch.data.void import VoidDataset
from super_primitive_tpu_torch.eval.dataset_trees import (
    write_png,
    write_replica_tree,
    write_tum_tree,
    write_void_tree,
)

FILTERS = {"adaptive": cv2.IMWRITE_PNG_ALL_FILTERS, "none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB, "up": cv2.IMWRITE_PNG_FILTER_UP,
           "average": cv2.IMWRITE_PNG_FILTER_AVG, "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}
FILTER_TYPE = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


def images():
    r = np.random.default_rng(0)
    H, W = 29, 41
    return {"gray8": r.integers(0, 256, (H, W), np.uint8),
            "rgb8": r.integers(0, 256, (H, W, 3), np.uint8),
            "rgba8": r.integers(0, 256, (H, W, 4), np.uint8),
            "gray16": r.integers(0, 65536, (H, W), np.uint16)}


def row_filters(path) -> set:
    """The filter types of a PNG's rows, read from its raw data."""
    import struct
    import zlib

    data = open(path, "rb").read()
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            W, H, depth, color = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(H, W * ch * depth // 8 + 1)[:, 0].tolist())


@pytest.mark.parametrize("kind", list(images()))
@pytest.mark.parametrize("flt", list(FILTERS))
def test_png_reader_matches_cv2(tmp_path, kind, flt):
    img = images()[kind]
    path = str(tmp_path / "x.png")
    # OpenCV takes and gives BGR(A); the file holds RGB(A)
    cv2.imwrite(path, img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img,
                [cv2.IMWRITE_PNG_FILTER, FILTERS[flt]])
    types = row_filters(path)
    assert types == ({FILTER_TYPE[flt]} if flt in FILTER_TYPE else {0, 1, 2, 3, 4})
    got = read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got[..., [2, 1, 0, 3][:got.shape[2]]] if got.ndim == 3 else got,
                                  ref)
    if img.dtype == np.uint8:
        np.testing.assert_array_equal(read_rgb(path), cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("kind", list(images()))
def test_png_writer_read_by_cv2(tmp_path, kind):
    img = images()[kind]
    path = str(tmp_path / "w.png")
    write_png(path, img)
    assert row_filters(path) == {0, 1, 2, 3, 4}
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("offset, value, message", [
    (24, 4, "4-bit"), (25, 3, "palette"), (28, 1, "interlaced")])
def test_png_reader_refuses(tmp_path, offset, value, message):
    path = tmp_path / "x.png"
    write_png(path, images()["gray8"])
    data = bytearray(path.read_bytes())
    data[offset] = value  # a field of IHDR (its CRC is not checked)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=message):
        read_png(str(path))


def test_png_reader_refuses_jpeg(tmp_path):
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, images()["rgb8"])
    with pytest.raises(ValueError, match="JPEG"):
        read_png(path)


K_UND = np.array([[520.9, 0, 80.0], [0, 521.0, 60.0], [0, 0, 1]], np.float64)
DIST = np.array([0.2312, -0.7849, -0.0033, -0.0001, 0.9172], np.float64)


def test_undistort_maps_match_cv2():
    h, w = 120, 160
    mx, my = undistort_maps(K_UND, DIST, h, w)
    cx, cy = cv2.initUndistortRectifyMap(K_UND, DIST, None, K_UND, (w, h), cv2.CV_32FC1)
    np.testing.assert_allclose(mx, cx, atol=1e-3, rtol=0)
    np.testing.assert_allclose(my, cy, atol=1e-3, rtol=0)


def test_remap_matches_cv2_undistort():
    h, w = 120, 160
    mx, my = undistort_maps(K_UND, DIST, h, w)
    interior = ((mx >= 0) & (mx < w - 1) & (my >= 0) & (my < h - 1))[..., None]
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    smooth = np.stack([200 * xx / w, 200 * yy / h, 100 * (xx / w + yy / h)], -1).astype(np.uint8)
    img = np.random.default_rng(0).integers(0, 255, (h, w, 3), np.uint8)
    for src in (smooth, img):
        diff = np.abs(remap_bilinear(src, mx, my).astype(int)
                      - cv2.undistort(src, K_UND, DIST).astype(int))
        if src is smooth:
            assert diff[np.broadcast_to(interior, diff.shape)].max() <= 2
        assert diff.max() <= 16


@pytest.fixture(scope="module")
def seq():
    return PlanesSequence(n_frames=4, H=96, W=128)


@pytest.fixture(scope="module")
def tum_tree(seq, tmp_path_factory):
    return write_tum_tree(tmp_path_factory.mktemp("tum"), seq, 3)


def assert_frames_equal(got, want, keys):
    for k in keys:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tum_matches_jax(tum_tree, seq):
    root = str(tum_tree)
    traj = str(tum_tree / "groundtruth.txt")
    K = tuple(float(v) for v in (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2]))
    got = TUMDataset(root, traj_file=traj, intrinsics=K)
    want = JTUM(root, traj_file=traj, intrinsics=K)
    assert len(got) == len(want) == 3
    for i in range(3):
        assert_frames_equal(got[i], want[i], ("image", "depth", "T", "intrinsics", "timestamp"))
        # the tree holds what was written
        np.testing.assert_array_equal(got[i]["image"],
                                      (np.clip(seq[i]["image"], 0, 1) * 255).astype(np.uint8))
        np.testing.assert_allclose(got[i]["T"], seq[i]["T"], atol=1e-6)
    assert TUMDataset(root)[0]["T"] is None


def test_tum_undistort_matches_jax(tum_tree):
    root, traj = str(tum_tree), str(tum_tree / "groundtruth.txt")
    got, want = TUMUndistortDataset(root, traj_file=traj), JTUMUndistort(root, traj_file=traj)
    for i in range(2):
        g, w = got[i], want[i]
        assert_frames_equal(g, w, ("depth", "T", "intrinsics", "timestamp"))
        assert g["image"].shape == w["image"].shape == (64, 64, 3)
        assert np.abs(g["image"].astype(int) - w["image"].astype(int)).max() <= 2


def test_replica_matches_jax(seq, tmp_path):
    root = write_replica_tree(tmp_path / "replica", seq, 2)
    normals_dir = tmp_path / "normals"
    normals_dir.mkdir()
    r = np.random.default_rng(3)
    for i in range(2):
        n = r.integers(0, 256, (96, 128, 3), np.uint8)
        n[:10] = 0
        cv2.imwrite(str(normals_dir / f"depth_{i}_tblr_k3.png"), n)
    got = ReplicaDataset(str(root), str(normals_dir))
    want = JReplica(str(root), str(normals_dir))
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_frames_equal(got[i], want[i], ("image", "depth", "T", "normals", "normals_mask",
                                              "intrinsics", "timestamp"))
    K = (100.0, 101.0, 60.0, 50.0)
    np.testing.assert_array_equal(ReplicaDataset(str(root), intrinsics=K)[0]["intrinsics"],
                                  JReplica(str(root), intrinsics=K)[0]["intrinsics"])


def test_void_matches_jax(seq, tmp_path):
    root = write_void_tree(tmp_path / "void", seq, 2, n_sparse=150, seed=5)
    # a gray image: OpenCV's colour read (and the port's) replicates it
    first = VoidDataset(str(root)).image_files[0]
    cv2.imwrite(str(root / first), np.random.default_rng(1).integers(0, 256, (96, 128), np.uint8))
    # ground truth outside the valid range (0.2, 5) m: missing and too far
    gt_path = str(root / first).replace("image", "ground_truth")
    gt = read_png(gt_path)
    gt[:20], gt[-20:] = 0, 6 * 256
    write_png(gt_path, gt)
    got, want = VoidDataset(str(root)), JVoid(str(root))
    assert len(got) == len(want) == 2
    keys = ("image", "sparse_depth", "validity_map", "gt_depth", "gt_valid", "intrinsics")
    for i in range(2):
        assert_frames_equal(got[i], want[i], keys)
        assert int((got[i]["sparse_depth"] > 0).sum()) == 150
    assert got[0]["gt_valid"].any() and not got[0]["gt_valid"][:20].any()
    assert np.isinf(got[0]["gt_depth"][-20:]).all()


def test_load_dataset_dispatch(tum_tree, seq, tmp_path):
    replica = write_replica_tree(tmp_path / "replica", seq, 1)
    void = write_void_tree(tmp_path / "void", seq, 1, n_sparse=10)
    cases = {"tum": (tum_tree, TUMDataset), "tum_undistort": (tum_tree, TUMUndistortDataset),
             "replica": (replica, ReplicaDataset), "void": (void, VoidDataset)}
    for kind, (path, cls) in cases.items():
        cfg = tload_config({"dataset": {"type": kind, "path": str(path)}})
        assert type(load_dataset(cfg.dataset)) is cls
        assert type(trun.load_dataset(cfg)) is cls
    cfg = tload_config({"dataset": {"type": "planes", "path": "linear"}})
    assert type(trun.load_dataset(cfg)) is PlanesSequence
    with pytest.raises(ValueError, match="unknown dataset type"):
        load_dataset(tload_config({"dataset": {"type": "kitti"}}).dataset)


def test_run_sfm_odometry_on_tum_tree(tum_tree, seq, tmp_path, capsys):
    """``run_sfm --odom --fake-frontend`` on the TUM tree: the structured
    fake's scene is the one the tree was rendered from."""
    import yaml

    K = [float(v) for v in (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])]
    cfg = {
        "save_path": str(tmp_path / "out"),
        "window_size": 4,
        "dataset": {"type": "tum", "path": str(tum_tree),
                    "traj_file": str(tum_tree / "groundtruth.txt"), "intrinsics": K},
        "frontend": {"downsample_pow": 0, "num_pts": 48, "num_pts_active": 16,
                     "normals": {"integration_shape": [48, 64], "network_dim": [96, 128]},
                     "cg_max_iter": 150, "cg_tol": 1e-3, "check_for_depth_disc": True},
        "sam_params": {"infer_resolution": [96, 128]},
        "alignment": {"mono_init": True, "init_frames": 3,
                      "track": {"pyramid_min": 0, "pyramid_max": 2, "steps": [0, 40]}},
    }
    path = tmp_path / "tum.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trun.main(["--config", str(path), "--odom", "--fake-frontend", "--device", "cpu",
               "--max-frames", "3"])
    out = capsys.readouterr().out
    traj = np.loadtxt(tmp_path / "out" / "converted_tum_traj.txt", ndmin=2)
    assert traj.shape[0] >= 1 and traj.shape[1] == 8 and np.isfinite(traj).all()
    assert "artifacts in" in out
