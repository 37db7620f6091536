"""Dataset trees in the TUM, Replica and VOID on-disk layouts, written from
the synthetic planes sequence, for the tests and ``chip_smoke.py``.

No real dataset is in the repository, so the loaders and the depth
completion are driven on these trees.  The files are written with
``data.image_io.write_png``, which cycles each file's rows through all five
PNG filters, so every file exercises the whole of the reader's
unfiltering.  Nothing on the library path imports this module.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from ..data.image_io import write_png

TUM_T0 = 1305031102.175304  # a TUM-like first timestamp


def image_u8(frame: dict) -> np.ndarray:
    """A PlanesSequence frame's float [0, 1] image as uint8."""
    return (np.clip(frame["image"], 0, 1) * 255).astype(np.uint8)


def depth_u16(depth: np.ndarray, scale: float) -> np.ndarray:
    """Metres -> the layout's 16-bit depth (``scale`` units a metre)."""
    return np.clip(np.round(depth * scale), 0, 65535).astype(np.uint16)


def write_tum_tree(root, seq, n: int) -> Path:
    """``rgb/``, ``depth/`` (1/5000 m), ``associations.txt`` and
    ``groundtruth.txt`` for the first ``n`` frames of ``seq``."""
    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    assoc, gt = [], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(n):
        f = seq[i]
        ts = f"{TUM_T0 + i / 30.0:.6f}"
        write_png(root / "rgb" / f"{ts}.png", image_u8(f))
        write_png(root / "depth" / f"{ts}.png", depth_u16(f["depth"], 5000.0))
        assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
        T = np.asarray(f["T"], np.float64)
        q = Rotation.from_matrix(T[:3, :3]).as_quat()
        gt.append(" ".join([ts] + [f"{v:.9f}" for v in (*T[:3, 3], *q)]))
    (root / "associations.txt").write_text("\n".join(assoc) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    return root


def write_replica_tree(root, seq, n: int) -> Path:
    """``rgb/rgb_i.png``, ``depth/depth_i.png`` (1/1000 m) and
    ``traj_w_c.txt`` for the first ``n`` frames of ``seq``."""
    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    for i in range(n):
        f = seq[i]
        write_png(root / "rgb" / f"rgb_{i}.png", image_u8(f))
        write_png(root / "depth" / f"depth_{i}.png", depth_u16(f["depth"], 1000.0))
    traj = np.stack([np.asarray(seq[i]["T"], np.float64).reshape(16) for i in range(n)])
    np.savetxt(root / "traj_w_c.txt", traj, delimiter=" ")
    return root


def write_void_tree(root, seq, n: int, n_sparse: int = 1500, seed: int = 0) -> Path:
    """A VOID-layout tree of the first ``n`` frames of ``seq``: 16-bit
    sparse depth, validity map and ground truth at 1/256 m, ``n_sparse``
    sparse pixels an image drawn from ``seed`` among the pixels with
    ground truth, ``K.txt`` two directories above the images and
    ``test_image.txt`` listing them."""
    root = Path(root)
    scene = root / f"void_{n_sparse}" / "data" / "planes"
    for sub in ("image", "sparse_depth", "validity_map", "ground_truth"):
        (scene / sub).mkdir(parents=True, exist_ok=True)
    r = np.random.default_rng(seed)
    names = []
    for i in range(n):
        f = seq[i]
        gt = depth_u16(f["depth"], 256.0)
        valid = np.flatnonzero(gt > 0)
        pick = r.choice(valid, size=min(n_sparse, valid.size), replace=False)
        sparse = np.zeros(gt.size, np.uint16)
        sparse[pick] = gt.reshape(-1)[pick]
        sparse = sparse.reshape(gt.shape)
        name = f"{i:05d}.png"
        write_png(scene / "image" / name, image_u8(f))
        write_png(scene / "sparse_depth" / name, sparse)
        write_png(scene / "validity_map" / name, (sparse > 0).astype(np.uint16))
        write_png(scene / "ground_truth" / name, gt)
        names.append(f"{scene.relative_to(root).as_posix()}/image/{name}")
    np.savetxt(scene / "K.txt", np.asarray(seq.K, np.float64))
    (root / "test_image.txt").write_text("\n".join(names) + "\n")
    return root
