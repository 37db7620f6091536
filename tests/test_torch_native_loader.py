"""The port's prefetching native loader (``data/native_loader.py`` over
``data/csrc/loader.cpp``) against the JAX package's native loader (libpng
and libjpeg, built here from ``csrc/``) and against the port's numpy reader
``image_io`` (CPU).

Bounds: PNG decodes (8-bit RGB, gray, gray + alpha, RGBA, 16-bit depth,
every row filter) equal both exactly; JPEG decodes equal JAX's libjpeg
decode exactly (the same library), or, where the build found no
``jpeglib.h``, raise naming it; ``undistort_maps`` / ``remap_u8`` equal the
JAX package's natives and the port's numpy ``data/undistort.py`` exactly;
``TUMDataset`` and ``TUMUndistortDataset`` give the same frames with the
loader and without it, and the same as the JAX package's.
"""

import os

import cv2
import numpy as np
import pytest

from super_primitive_tpu.data import native_loader as jnl
from super_primitive_tpu.data.tum import TUMUndistortDataset as JTUMUndistort
from super_primitive_tpu_torch.data import image_io
from super_primitive_tpu_torch.data import native_loader as tnl
from super_primitive_tpu_torch.data import undistort
from super_primitive_tpu_torch.data.synthetic import PlanesSequence
from super_primitive_tpu_torch.data.tum import TUMDataset, TUMUndistortDataset
from super_primitive_tpu_torch.eval.dataset_trees import write_tum_tree

K_UND = np.array([[520.9, 0, 80.0], [0, 521.0, 60.0], [0, 0, 1]], np.float64)
DIST = np.array([0.2312, -0.7849, -0.0033, -0.0001, 0.9172], np.float64)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNGs of every kind (cv2's and the port's writer) and JPEGs (cv2's
    colour ones, the port's gray ones)."""
    d = tmp_path_factory.mktemp("imgs")
    r = np.random.default_rng(0)
    out = {"rgb": [], "depth": [], "png": [], "jpg": [], "gray_jpg": []}
    for i in range(4):
        p = str(d / f"rgb{i}.png")
        cv2.imwrite(p, r.integers(0, 255, (32, 40, 3), np.uint8))
        out["rgb"].append(p)
        p = str(d / f"d{i}.png")
        cv2.imwrite(p, r.integers(0, 60000, (32, 40)).astype(np.uint16))
        out["depth"].append(p)
        p = str(d / f"j{i}.jpg")
        cv2.imwrite(p, r.integers(0, 255, (32, 40, 3), np.uint8))
        out["jpg"].append(p)
        yy, xx = np.mgrid[:29, :43]
        gray = np.clip(120 + 50 * np.sin(xx / (3.0 + i)) + 30 * np.cos(yy / 5.0)
                       + r.normal(0, 8, xx.shape), 0, 255).astype(np.uint8)
        p = str(d / f"g{i}.jpg")
        image_io.write_jpeg(p, gray)
        out["gray_jpg"].append((p, gray))
    for shape, dtype in (((17, 23), np.uint8), ((9, 11, 2), np.uint8), ((12, 10, 4), np.uint8),
                         ((9, 11, 3), np.uint16), ((15, 7), np.uint16)):
        p = str(d / f"w{len(out['png'])}.png")
        image_io.write_png(p, r.integers(0, np.iinfo(dtype).max, shape).astype(dtype))
        out["png"].append(p)
    return out


def test_png_rgb_exact(files):
    with tnl.NativeImageLoader(files["rgb"]) as nl:
        j = jnl.NativeImageLoader(files["rgb"])
        for i, p in enumerate(files["rgb"]):
            got = nl[i]
            np.testing.assert_array_equal(got, j[i])
            np.testing.assert_array_equal(got, image_io.read_png(p))
            np.testing.assert_array_equal(nl.rgb(i), image_io.read_rgb(p))
        j.close()


def test_png_depth16_exact(files):
    with tnl.NativeImageLoader(files["depth"]) as nl:
        j = jnl.NativeImageLoader(files["depth"])
        for i, p in enumerate(files["depth"]):
            got = nl[i]
            assert got.dtype == np.uint16
            np.testing.assert_array_equal(got, j[i])
            np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_UNCHANGED))
        j.close()


def test_png_every_kind_and_filter(files):
    """The port's writer cycles rows through the five filters."""
    with tnl.NativeImageLoader(files["png"], num_threads=2) as nl:
        for i, p in enumerate(files["png"]):
            want = image_io.read_png(p)
            got = nl[i]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_jpeg_exact_to_jax(files):
    paths = files["jpg"] + [p for p, _ in files["gray_jpg"]]
    with tnl.NativeImageLoader(paths) as nl:
        if not tnl.has_jpeg():
            with pytest.raises(IOError, match="jpeglib.h"):
                nl[0]
            return
        j = jnl.NativeImageLoader(paths)
        for i in range(len(paths)):
            np.testing.assert_array_equal(nl[i], j[i])
        j.close()


def test_write_jpeg(files):
    """The port's baseline gray JPEG writer: cv2 reads its files, and the
    decode stays near the image written (flat quantisation of 4)."""
    if not tnl.has_jpeg():
        pytest.skip("the native loader was built without jpeglib.h")
    with tnl.NativeImageLoader([p for p, _ in files["gray_jpg"]]) as nl:
        for i, (p, gray) in enumerate(files["gray_jpg"]):
            got = nl[i]
            assert got.shape == gray.shape and got.dtype == np.uint8
            np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_UNCHANGED))
            assert np.abs(got.astype(int) - gray).max() <= 6


def test_random_access_and_reuse(files):
    with tnl.NativeImageLoader(files["rgb"], num_threads=2, lookahead=2) as nl:
        a, b, c = nl[3], nl[0], nl[3]  # index 3 again, after it was consumed
        np.testing.assert_array_equal(a, image_io.read_png(files["rgb"][3]))
        np.testing.assert_array_equal(b, image_io.read_png(files["rgb"][0]))
        np.testing.assert_array_equal(c, a)
        with pytest.raises(IndexError):
            nl[4]


def test_stress_more_threads_than_cores(tmp_path):
    """Twelve decode threads over 30 files, read twice in shuffled orders
    with a short lookahead, so images are evicted, decoded again and
    awaited while others decode."""
    r = np.random.default_rng(5)
    imgs = [r.integers(0, 255, (20 + i % 7, 16 + i % 5, 3), np.uint8) for i in range(30)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"{i}.png"))
        image_io.write_png(paths[-1], img)
    with tnl.NativeImageLoader(paths, num_threads=12, lookahead=3) as nl:
        for order in (r.permutation(30), r.permutation(30)):
            for i in order:
                np.testing.assert_array_equal(nl[int(i)], imgs[i])


@pytest.mark.parametrize("content, message", [
    (b"not a png", "not a PNG"),
    (None, "truncated PNG"),
    (b"", "not a PNG"),
])
def test_decode_error(tmp_path, files, content, message):
    bad = tmp_path / "bad.png"
    if content is None:  # a PNG cut before its IEND chunk
        content = open(files["rgb"][0], "rb").read()[:-12]
    bad.write_bytes(content)
    with tnl.NativeImageLoader([str(bad)]) as nl:
        with pytest.raises(IOError, match=message):
            nl[0]
    with tnl.NativeImageLoader([str(tmp_path / "missing.png")]) as nl:
        with pytest.raises(IOError, match="cannot read"):
            nl[0]


def test_failed_build_raises(tum_tree, tmp_path, monkeypatch):
    """A loader that cannot be built stops the dataset: it raises, and
    nothing decodes with ``image_io`` in its place."""
    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "SOURCE", broken)
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="building the native loader failed"):
        TUMDataset(str(tum_tree))
    assert TUMDataset(str(tum_tree), native=False)[0]["image"].shape == (96, 128, 3)


def test_default_threads_leave_a_core():
    assert 1 <= tnl.default_threads() <= max(1, len(os.sched_getaffinity(0)) - 1)


def test_library_named_by_source_and_flags():
    lib = tnl.build()
    assert lib.parent.name == "host" and lib.name.startswith("loader-") and lib.is_file()
    assert lib == tnl._library_path(tnl.build_flags())


def test_undistort_maps_and_remap_match_jax_and_numpy():
    h, w = 120, 160
    mx, my = tnl.undistort_maps(K_UND, DIST, h, w)
    jx, jy = jnl.undistort_maps(K_UND, DIST, h, w)
    ux, uy = undistort.undistort_maps(K_UND, DIST, h, w)
    for got, *wants in ((mx, jx, ux), (my, jy, uy)):
        for want in wants:
            np.testing.assert_array_equal(got, want)
    r = np.random.default_rng(0)
    for img in (r.integers(0, 255, (h, w, 3), np.uint8), r.integers(0, 255, (h, w), np.uint8)):
        got = tnl.remap_u8(img, mx, my)
        np.testing.assert_array_equal(got, jnl.remap_u8(img, jx, jy))
        np.testing.assert_array_equal(got, undistort.remap_bilinear(img, ux, uy))
    with pytest.raises(ValueError, match="plumb-bob"):
        tnl.undistort_maps(K_UND, np.zeros(8), h, w)


def test_loader_undistort_on_decode_threads(tmp_path):
    """Maps attached after the first prefetches: every image comes out
    remapped, as ``remap_u8`` remaps it."""
    r = np.random.default_rng(1)
    h, w = 96, 128
    imgs, paths = [], []
    for i in range(5):
        imgs.append(r.integers(0, 255, (h, w, 3), np.uint8))
        paths.append(str(tmp_path / f"im{i}.png"))
        image_io.write_png(paths[-1], imgs[-1])
    maps = tnl.undistort_maps(K_UND, DIST, h, w)
    with tnl.NativeImageLoader(paths, num_threads=2, lookahead=4) as nl:
        nl.set_undistort(*maps)
        for i in (0, 2, 4, 3, 1):
            np.testing.assert_array_equal(nl[i], tnl.remap_u8(imgs[i], *maps))


@pytest.fixture(scope="module")
def tum_tree(tmp_path_factory):
    return write_tum_tree(tmp_path_factory.mktemp("tum"), PlanesSequence(n_frames=3, H=96, W=128),
                          3)


def test_tum_native_equals_image_io(tum_tree):
    root, traj = str(tum_tree), str(tum_tree / "groundtruth.txt")
    native, plain = TUMDataset(root, traj_file=traj), TUMDataset(root, traj_file=traj,
                                                                 native=False)
    assert native._rgb_loader is not None and plain._rgb_loader is None
    for i in (0, 2, 1):
        a, b = native[i], plain[i]
        for k in ("image", "depth", "T", "intrinsics", "timestamp"):
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tum_undistort_pipeline_matches_jax(tum_tree):
    """The undistort on the decode threads against the numpy remap and
    against the JAX package's pipeline (its natives on its own threads)."""
    root, traj = str(tum_tree), str(tum_tree / "groundtruth.txt")
    native = TUMUndistortDataset(root, traj_file=traj)
    plain = TUMUndistortDataset(root, traj_file=traj, native=False)
    want = JTUMUndistort(root, traj_file=traj)
    assert native._native_hw == (96, 128)
    for i in range(3):
        a, b, c = native[i], plain[i], want[i]
        for k in ("image", "depth", "T", "intrinsics", "timestamp"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
