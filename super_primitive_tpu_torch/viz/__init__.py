"""Run artifacts and the live viewer: PLY point clouds, residual and
trajectory PNGs (``export``), the interactive HTML viewer (``viewer``), live
snapshots with a pause protocol (``live``) and their server (``serve``)."""

from . import export

__all__ = ["export"]
