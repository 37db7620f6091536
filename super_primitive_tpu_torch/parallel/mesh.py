"""The (dp, sp) device mesh and its sharded layouts over ``torch.distributed``.

Port of ``super_primitive_tpu/parallel/mesh.py``.  The mesh axes are the
two parallel dimensions of the photometric problem:

- ``dp`` over target frames (the mapping targets, an encode's image batch);
- ``sp`` over bundle points, and over segments in BiNI and the labeller.

The JAX package places its arrays with a ``NamedSharding`` and GSPMD
inserts the collectives.  Here the data is placed by hand and carries what
its reductions need.  A sharded bundle or window
(:func:`shard_bundle`, :func:`shard_window`) holds this rank's contiguous
range of each bundle's valid points, the global point count in
``num_valid`` (the denominator of every mean), and the process group to
reduce over in ``group``.  The solvers end their partial sums in
:func:`reduce_sum` / :func:`reduce_min` and reassemble a row-sharded result
with :func:`gather_rows`.  Each returns its input object untouched when
the group is None, so on unsharded data every existing path runs exactly
as before.

Rank layout: rank = dp_rank * sp + sp_rank, the JAX mesh's
``devices.reshape(dp, sp)``.  Every rank creates every group, in the same
order, as ``torch.distributed.new_group`` requires.

Gloo takes CUDA tensors in every collective used here (``all_reduce``
with SUM and MIN, ``all_gather``) and copies them through host memory
itself, so two ranks can share one card over gloo; NCCL needs a card per
rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..keyframe import PointBundle
from ..odometry.window import WindowBuffers


@dataclasses.dataclass(frozen=True)
class Group:
    """One process group of the mesh and this process's place in it."""

    pg: object                 # the torch.distributed ProcessGroup
    ranks: tuple[int, ...]     # global ranks, in group order
    rank: int                  # this process's index in ``ranks``

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) mesh over the initialised process group: ``world``, and
    the ``dp`` and ``sp`` axes through this rank."""

    world: Group
    dp: Group                  # the ranks that share this rank's sp index
    sp: Group                  # the ranks that share this rank's dp index
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.dp.size, "sp": self.sp.size}


def mesh_shape(n: int) -> tuple[int, int]:
    """(dp, sp) of an n-device mesh: sp (points) is the large axis, dp gets
    a factor of 2 when n is even and at least 4."""
    dp = 2 if (n % 2 == 0 and n >= 4) else 1
    return dp, n // dp


def make_mesh(n: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """The (dp, sp) mesh over the initialised default process group of
    ``n`` ranks (its world size; None takes it).  ``device`` is where this
    rank's tensors live; a CUDA device without an index is the current
    one."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} ranks")
    dp, sp = mesh_shape(n)
    me = dist.get_rank()

    def group(ranks):
        ranks = tuple(ranks)
        pg = dist.new_group(list(ranks))
        return Group(pg=pg, ranks=ranks, rank=ranks.index(me) if me in ranks else -1)

    sp_groups = [group(range(d * sp, (d + 1) * sp)) for d in range(dp)]
    dp_groups = [group(range(s, n, sp)) for s in range(sp)]
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world=Group(pg=dist.group.WORLD, ranks=tuple(range(n)), rank=me),
                dp=dp_groups[me % sp], sp=sp_groups[me // sp], device=device)


# ------------------------------------------------------------------ reducers

def reduce_sum(tensors, group: Group | None):
    """The sums over ``group`` of a tensor or a tuple of tensors, in one
    collective: every tensor is packed into one flat buffer.  With no group
    it returns ``tensors`` itself."""
    if group is None:
        return tensors
    single = torch.is_tensor(tensors)
    ts = (tensors,) if single else tuple(tensors)
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1:
        raise ValueError(f"reduce_sum packs one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.pg)
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out[0] if single else tuple(out)


def reduce_min(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The elementwise minimum of ``x`` over ``group``; ``x`` itself with
    no group."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group.pg)
    return x


@dataclasses.dataclass(frozen=True)
class RowShard:
    """How :func:`shard_rows` split a leading axis of ``n`` rows over
    ``group``: blocks of ``block`` rows, the last ones padded."""

    group: Group
    n: int
    block: int


def shard_rows(x: torch.Tensor, group: Group | None):
    """This rank's contiguous block of the leading axis of ``x``, padded
    with zero rows to a multiple of the group's size, and the
    :class:`RowShard` that :func:`gather_rows` undoes.  With no group it
    returns (``x``, None)."""
    if group is None:
        return x, None
    n = x.shape[0]
    block = -(-n // group.size) if n else 0
    pad = block * group.size - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x[group.rank * block:(group.rank + 1) * block], RowShard(group, n, block)


def _all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x.contiguous(), group=group.pg)
    return torch.cat(parts)


def gather_rows(x: torch.Tensor, rows: RowShard | None) -> torch.Tensor:
    """The per-rank results of :func:`shard_rows` blocks reassembled in the
    unsharded row order, padding dropped; ``x`` itself with no shard."""
    if rows is None:
        return x
    if x.shape[0] != rows.block:
        raise ValueError(f"{x.shape[0]} rows where the shard holds {rows.block}")
    is_bool = x.dtype == torch.bool
    out = _all_gather(x.to(torch.uint8) if is_bool else x, rows.group)[: rows.n]
    return out.to(torch.bool) if is_bool else out


def same_on_all_ranks(tensors, group: Group) -> bool:
    """Whether every rank of ``group`` holds ``tensors`` (of one shape on
    every rank) bit for bit: one all-gather of their bytes."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    parts = _all_gather(flat, group).reshape(group.size, -1)
    return all(bool(torch.equal(p, flat)) for p in parts)


# ------------------------------------------------------------ placed data

def _block(n: int, group: Group) -> tuple[int, int]:
    """Contiguous range of ``n`` rows held by this rank of ``group``."""
    return n * group.rank // group.size, n * (group.rank + 1) // group.size


@dataclasses.dataclass
class ShardedBundle(PointBundle):
    """This rank's contiguous range ``[start, start + len(uv))`` of a
    bundle's valid points; ``num_valid`` stays the global count."""

    start: int = 0
    group: Group | None = None


def shard_bundle(bundle: PointBundle, mesh: Mesh) -> ShardedBundle:
    """``bundle``'s valid points split over ``sp``.  Points past
    ``num_valid`` are padding and go nowhere: bundles are front-compacted."""
    lo, hi = _block(int(bundle.num_valid), mesh.sp)
    return ShardedBundle(uv=bundle.uv[lo:hi], seg_id=bundle.seg_id[lo:hi],
                         base_logdepth=bundle.base_logdepth[lo:hi],
                         valid=bundle.valid[lo:hi], num_valid=int(bundle.num_valid),
                         start=lo, group=mesh.sp)


@dataclasses.dataclass
class ShardedWindow(WindowBuffers):
    """Window buffers whose bundle arrays (W, P', ...) hold, per slot, this
    rank's ``point_rows`` points from global row ``point_start``;
    ``num_valid`` stays the global counts and everything else is
    replicated."""

    mesh: Mesh | None = None
    point_start: np.ndarray | None = None   # (W,) int64
    point_rows: np.ndarray | None = None    # (W,) int64

    @property
    def group(self) -> Group | None:
        return self.mesh.sp

    def bundle_at(self, i: int) -> ShardedBundle:
        n = int(self.point_rows[i])
        return ShardedBundle(
            uv=self.uv[i, :n], seg_id=self.seg_id[i, :n],
            base_logdepth=self.base_logdepth[i, :n], valid=self.point_valid[i, :n],
            num_valid=int(self.num_valid[i]), start=int(self.point_start[i]),
            group=self.mesh.sp)


def shard_window(buffers: WindowBuffers, mesh: Mesh) -> ShardedWindow:
    """Place ``buffers`` for a sharded mapping or tracking solve: each
    slot's valid points split over ``sp``, everything else replicated (the
    same tensors).  The per-point warp and linearization are local, and the
    solvers reduce their sums over ``sp``."""
    spans = [_block(int(n), mesh.sp) for n in buffers.num_valid]
    start = np.asarray([lo for lo, _ in spans], np.int64)
    rows = np.asarray([hi - lo for lo, hi in spans], np.int64)
    P = int(rows.max()) if len(rows) else 0

    def take(x):
        out = x.new_zeros((x.shape[0], P) + tuple(x.shape[2:]))
        for i, (lo, hi) in enumerate(spans):
            out[i, :hi - lo] = x[i, lo:hi]
        return out

    fields = {f.name: getattr(buffers, f.name) for f in dataclasses.fields(WindowBuffers)}
    for name in ("uv", "seg_id", "base_logdepth", "point_valid"):
        fields[name] = take(fields[name])
    return ShardedWindow(**fields, mesh=mesh, point_start=start, point_rows=rows)


def shard_targets(targets, mesh: Mesh | None):
    """This rank's contiguous share of a sequence of targets over ``dp``;
    ``targets`` itself with no mesh."""
    if mesh is None:
        return targets
    lo, hi = _block(len(targets), mesh.dp)
    return targets[lo:hi]
