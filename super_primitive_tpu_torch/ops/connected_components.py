"""Batched 2D connected-component labelling on the input's device.

Port of ``super_primitive_tpu/ops/connected_components.py``
(``label_components`` and ``relabel_consecutive_np``), one labeller: the
JAX package's chain of native, device and scipy labellers becomes this
PyTorch function, which runs wherever its input lies.

Labels: background -1; a foreground pixel's label is the minimum linear
index (row * W + col) of the pixels of its 4-connected component within its
own mask.  That is the fixpoint of min-label propagation, so any order of
sweeps gives the same labels as the JAX package.

Algorithm: alternating row and column segmented min-scans (``cummin`` with
a per-run offset, so a run of foreground pixels takes its minimum in one
pass) plus one pointer jump per sweep, until nothing changes.  Blob-shaped
masks converge in two or three sweeps.

``group`` shards the masks over a process group: each rank iterates to
its own block's fixed point with no collective inside the loop, and the
labels, linear indices within each mask, gather exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import gather_rows, shard_rows
from ..utils import timing


def _seg_min_scan(vals: torch.Tensor, boundary: torch.Tensor, dim: int,
                  big: int) -> torch.Tensor:
    """Running minimum of ``vals`` (int64 in [0, big]) along ``dim``,
    restarting after every ``boundary`` position.

    Each run between boundaries gets an offset that falls by ``big + 1``
    per run, so a cummin never carries a smaller value out of an earlier
    run."""
    run = torch.cumsum(boundary.to(torch.int64), dim=dim)
    key = vals - run * (big + 1)
    return torch.cummin(key, dim=dim).values + run * (big + 1)


def label_components(masks: torch.Tensor, group=None) -> torch.Tensor:
    """Label the 4-connected components of (N, H, W) bool masks.

    Returns int32 labels on the masks' device: background -1, else the
    component's minimum linear index (unique within each mask, not
    renumbered; see :func:`relabel_consecutive_np`).  ``group``: the masks
    shard over it (module docstring)."""
    masks, part = shard_rows(masks.to(torch.bool), group)
    N, H, W = masks.shape
    big = H * W
    lin = torch.arange(H * W, dtype=torch.int64, device=masks.device).reshape(1, H, W)
    labels = torch.where(masks, lin, torch.full_like(lin, big))
    bg = ~masks

    def sweep(l):
        l = _seg_min_scan(l, bg, 2, big)
        l = _seg_min_scan(l.flip(2), bg.flip(2), 2, big).flip(2)
        l = _seg_min_scan(l, bg, 1, big)
        l = _seg_min_scan(l.flip(1), bg.flip(1), 1, big).flip(1)
        return torch.where(masks, l, torch.full_like(l, big))

    def jump(l):
        flat = l.reshape(N, H * W)
        jumped = torch.gather(flat, 1, torch.clamp(flat, max=H * W - 1)).reshape(N, H, W)
        return torch.where(masks, torch.minimum(l, jumped), torch.full_like(l, big))

    labels = sweep(labels)
    while True:
        new = jump(sweep(labels))
        if timing.host_flag(torch.equal(new, labels)):
            break
        labels = new
    return gather_rows(torch.where(masks, labels, torch.full_like(labels, -1)).to(torch.int32),
                       part)


def relabel_consecutive_np(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Renumber one (H, W) label image to consecutive 0..K-1 over its unique
    labels (background -1 included as a label)."""
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    out = np.searchsorted(uniq, labels)
    return out.astype(np.int32), len(uniq)
