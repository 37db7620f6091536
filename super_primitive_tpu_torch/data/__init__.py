"""Datasets (port of super_primitive_tpu/data): the synthetic planes
scenes, and the TUM, Replica and VOID loaders, with the port's own PNG
reader and its prefetching native loader (TUM)."""

from __future__ import annotations


def load_dataset(ds):
    """A real-data loader for a config's ``dataset`` section
    (``config.schema.DatasetConfig``): ``replica``, ``tum``,
    ``tum_undistort`` or ``void``."""
    kind = ds.type
    if kind == "replica":
        from .replica import ReplicaDataset

        return ReplicaDataset(ds.path, ds.normals_path, intrinsics=ds.intrinsics)
    if kind == "tum":
        from .tum import TUMDataset

        return TUMDataset(ds.path, traj_file=ds.traj_file, intrinsics=ds.intrinsics)
    if kind == "tum_undistort":
        from .tum import TUMUndistortDataset

        return TUMUndistortDataset(ds.path, traj_file=ds.traj_file)
    if kind == "void":
        from .void import VoidDataset

        return VoidDataset(ds.path)
    raise ValueError(f"unknown dataset type: {kind!r}")
