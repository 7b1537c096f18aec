"""Process meshes: data-parallel and spatially sharded work over ranks
(port of ``diffnet_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``('data', 'space')`` Mesh and
lets GSPMD do the rest: ``jit`` over batch-sharded arrays emits the
gradient all-reduce, and row-sharded fields get their halo exchanges from
the compiler. PyTorch has no GSPMD, so here every piece is explicit: one
process a rank, a process group along each mesh axis, a rank's rows of a
batch, the all-reduces, and the halo exchange of a row-sharded field.

JAX's names and their counterparts:

* ``make_mesh`` -> :func:`make_mesh`, a :class:`Mesh` of process groups;
* ``data_sharding`` / ``spatial_sharding`` (placing a global array) ->
  :func:`local_block` (a rank's block of a global array along one axis)
  and :func:`gather_block` (the global array back from the blocks);
* ``replicated`` -> :func:`replicate` (the first rank's values on every
  rank);
* ``shard_batch`` -> :func:`shard_batch`;
* ``halo_exchange_y`` / ``halo_exchange_z`` -> the same names, an
  autograd function whose backward sends the halo cotangents back and adds
  them into the neighbours' edge rows (the transpose of ``ppermute`` that
  JAX derives by itself).

The backend follows the device: NCCL carries CUDA tensors, one rank a
card; gloo carries CPU tensors. On a gloo group CUDA tensors travel through
host copies (gloo's send and receive take host memory), which lets several
ranks share one card; the compute stays on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "shard_batch", "local_block", "gather_block",
           "replicate", "halo_exchange", "halo_exchange_y",
           "halo_exchange_z"]


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``data x space`` grid of ranks.

    ranks: the global ranks laid out row-major, rank ``ranks[d * space +
    s]`` at ``(d, s)``; rank: this process's global rank; data_group,
    space_group: the process groups along each axis through this rank;
    group: the group of all the mesh's ranks (None for the whole world);
    backend: the groups' backend."""

    data: int
    space: int
    ranks: tuple[int, ...]
    rank: int
    data_group: Any
    space_group: Any
    group: Any
    backend: str

    @property
    def data_index(self) -> int:
        return self.ranks.index(self.rank) // self.space

    @property
    def space_index(self) -> int:
        return self.ranks.index(self.rank) % self.space

    @property
    def lead(self) -> bool:
        """Whether this is the mesh's first rank (the one that writes)."""
        return self.rank == self.ranks[0]

    def size(self, axis: str) -> int:
        return {"data": self.data, "space": self.space}[axis]

    def index(self, axis: str) -> int:
        return {"data": self.data_index, "space": self.space_index}[axis]

    def axis_group(self, axis: str):
        return {"data": self.data_group, "space": self.space_group}[axis]

    def space_neighbour(self, step: int) -> int | None:
        """The global rank `step` places along 'space', None past an edge."""
        s = self.space_index + step
        if not 0 <= s < self.space:
            return None
        return self.ranks[self.data_index * self.space + s]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def to_comm(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of `t` that the backend can send: on the host for gloo."""
        t = t.detach()
        return t.cpu().clone() if self._staged(t) else t.clone()

    def all_reduce(self, t: torch.Tensor, axis: str = "data",
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``) or mean (``"mean"``) of `t` over the ranks
        along `axis`, on every one of them, as a new tensor on `t`'s device
        (`t` itself is left as it is)."""
        if op not in ("sum", "mean"):
            raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
        n = self.size(axis)
        if n == 1:
            return t.detach().clone()
        buf = self.to_comm(t)
        dist.all_reduce(buf, dist.ReduceOp.SUM, group=self.axis_group(axis))
        if op == "mean":
            buf /= n
        return buf.to(t.device)


def make_mesh(data: int | None = None, space: int = 1,
              group: Sequence[int] | None = None) -> Mesh | None:
    """The ranks of `group` (global ranks, default every rank of the world)
    laid out as a ``data x space`` grid: rank ``group[r]`` sits at ``(r //
    space, r % space)``, as JAX's ``reshape(data, space)`` of its devices.
    ``data=None`` takes ``len(group) // space``; the grid uses the first
    ``data * space`` ranks. Every process of the world must call it
    (``torch.distributed.new_group``'s rule); a process outside the grid
    gets None. The process group must be initialised."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(init_process_group first)")
    world = dist.get_world_size()
    ranks = list(range(world)) if group is None else [int(r) for r in group]
    if data is None:
        data = len(ranks) // space
    if data < 1 or space < 1 or data * space > len(ranks):
        raise ValueError(f"make_mesh: a {data} x {space} grid does not fit "
                         f"{len(ranks)} ranks")
    ranks = ranks[:data * space]
    rank = dist.get_rank()
    whole = None if ranks == list(range(world)) else dist.new_group(ranks)
    data_group = space_group = None
    # every process creates every group, in the same order
    for s in range(space):
        members = [ranks[d * space + s] for d in range(data)]
        g = dist.new_group(members)
        if rank in members:
            data_group = g
    for d in range(data):
        members = ranks[d * space:(d + 1) * space]
        g = dist.new_group(members)
        if rank in members:
            space_group = g
    if rank not in ranks:
        return None
    return Mesh(data, space, tuple(ranks), rank, data_group, space_group,
                whole, dist.get_backend())


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local_block(x, mesh: Mesh, axis: int = 0, mesh_axis: str = "data"):
    """This rank's block of a global array (numpy or torch) along `axis`:
    the ``index(mesh_axis)``-th of ``size(mesh_axis)`` equal blocks. The
    axis must divide evenly."""
    n, k = x.shape[axis], mesh.size(mesh_axis)
    if n % k:
        raise ValueError(f"local_block: axis {axis} of length {n} does not "
                         f"split into {k} equal blocks along '{mesh_axis}'")
    m = n // k
    i = mesh.index(mesh_axis) * m
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, i, m)
    return np.take(x, np.arange(i, i + m), axis=axis)


def gather_block(x: torch.Tensor, mesh: Mesh, axis: int = 0,
                 mesh_axis: str = "space") -> torch.Tensor:
    """The global tensor from the blocks of the ranks along `mesh_axis`
    (the inverse of :func:`local_block`), on every one of them."""
    k = mesh.size(mesh_axis)
    if k == 1:
        return x
    buf = mesh.to_comm(x.contiguous())
    parts = [torch.empty_like(buf) for _ in range(k)]
    dist.all_gather(parts, buf, group=mesh.axis_group(mesh_axis))
    return torch.cat(parts, dim=axis).to(x.device)


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Copy the mesh's first rank's values into `tensors` on every rank (in
    place, one broadcast for each dtype among them)."""
    if len(mesh.ranks) == 1:
        return
    by_type: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_type.setdefault(t.dtype, []).append(t)
    for group in by_type.values():
        flat = mesh.to_comm(torch.cat([t.reshape(-1) for t in group]))
        dist.broadcast(flat, src=mesh.ranks[0], group=mesh.group)
        flat = flat.to(group[0].device)
        i = 0
        for t in group:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def shard_batch(batch: Any, mesh: Mesh, batch_size: int | None = None):
    """This rank's rows of a global batch (a tuple, list or dict of arrays
    or tensors) along the 'data' axis.

    Only leaves whose axis 0 matches the batch size (taken from the first
    leaf of at least one dimension unless `batch_size` is passed) are
    split; scalars and shared per-sample arrays (masks, coordinates) are
    kept whole on every rank: splitting them row-wise would hand each rank
    the wrong rows.

    Caveat (as in the JAX package): a shared per-sample array whose leading
    axis coincidentally equals the batch size (e.g. coords shaped
    ``[bs, 2]``) would be row-split. Pass `batch_size` explicitly (or shape
    shared leaves so axis 0 differs from the batch) when a batch can hold
    such leaves."""
    leaves = [x for x in _leaves(batch) if np.ndim(x) >= 1]
    bs = (batch_size if batch_size is not None
          else np.shape(leaves[0])[0] if leaves else None)

    def take(x):
        if np.ndim(x) >= 1 and np.shape(x)[0] == bs:
            return local_block(x, mesh, 0, "data")
        return x

    return _map(take, batch)


class _HaloExchange(torch.autograd.Function):
    """Grow a block by `halo` slices of its neighbours along `axis`: the
    slices of the ranks before and after it along 'space'. At a domain edge
    the grown side is zero-filled (``zero_edges``) or left off (the block
    then grows on one side only)."""

    @staticmethod
    def forward(ctx, x, mesh, halo, axis, zero_edges):
        n = x.shape[axis]
        if not 1 <= halo <= n:
            raise ValueError(f"halo {halo} must be in [1, {n}] (the block's "
                             "slices)")
        prev, nxt = mesh.space_neighbour(-1), mesh.space_neighbour(1)
        from_prev, from_next = _swap(
            mesh, x.narrow(axis, 0, halo), x.narrow(axis, n - halo, halo),
            prev, nxt)
        shape = list(x.shape)
        shape[axis] = halo
        if from_prev is None and zero_edges:
            from_prev = x.new_zeros(shape)
        if from_next is None and zero_edges:
            from_next = x.new_zeros(shape)
        ctx.mesh, ctx.halo, ctx.axis, ctx.n = mesh, halo, axis, n
        ctx.prev, ctx.nxt = prev, nxt
        ctx.lo = 0 if from_prev is None else halo
        parts = [t for t in (from_prev, x, from_next) if t is not None]
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        halo, axis, n, lo = ctx.halo, ctx.axis, ctx.n, ctx.lo
        dx = g.narrow(axis, lo, n).clone()
        # the halo cotangents go back to the slices' owners (a zero-filled
        # edge depends on nothing); the neighbours' cotangents of this
        # block's edge slices come here
        g_prev = g.narrow(axis, 0, halo) if ctx.prev is not None else None
        g_next = g.narrow(axis, lo + n, halo) if ctx.nxt is not None else None
        to_first, to_last = _swap(ctx.mesh, g_prev, g_next, ctx.prev,
                                  ctx.nxt)
        if to_first is not None:
            dx.narrow(axis, 0, halo).add_(to_first)
        if to_last is not None:
            dx.narrow(axis, n - halo, halo).add_(to_last)
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, mesh: Mesh, halo: int, axis: int,
                  zero_edges: bool = True) -> torch.Tensor:
    """`x` (this rank's block along `axis`) grown by `halo` slices of each
    neighbour along 'space'. With `zero_edges` the domain edges are
    zero-filled, so every block grows by ``2 * halo``; without, a block at
    a domain edge grows on its inner side only. Differentiable."""
    axis = axis % x.dim()
    if mesh.space == 1 and not zero_edges:
        return x
    return _HaloExchange.apply(x, mesh, halo, axis, zero_edges)


def halo_exchange_y(x: torch.Tensor, mesh: Mesh, halo: int = 1
                    ) -> torch.Tensor:
    """Halo exchange along the sharded y (rows, axis -2) axis, the domain
    edges zero-filled: ``[..., y_local, x] -> [..., y_local + 2*halo, x]``."""
    return halo_exchange(x, mesh, halo, x.dim() - 2)


def halo_exchange_z(x: torch.Tensor, mesh: Mesh, halo: int = 1
                    ) -> torch.Tensor:
    """Halo exchange along the sharded z (depth, axis -3) axis, the domain
    edges zero-filled: ``[..., z_local, y, x] -> [..., z_local + 2*halo, y,
    x]``."""
    return halo_exchange(x, mesh, halo, x.dim() - 3)


def _swap(mesh: Mesh, lo, hi, prev, nxt):
    """Send `lo` to `prev` and `hi` to `nxt` (either may be None where there
    is no such neighbour); receive, of the same shapes, what `prev` sends
    up and `nxt` sends down. Returns ``(from_prev, from_next)`` on the
    sent tensors' device, None where there is no neighbour."""
    ops, recv = [], {}
    group = mesh.space_group
    like = lo if lo is not None else hi
    for peer, out in ((prev, lo), (nxt, hi)):
        if peer is None:
            continue
        buf = mesh.to_comm(out.contiguous())
        recv[peer] = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.isend, buf, peer, group))
        ops.append(dist.P2POp(dist.irecv, recv[peer], peer, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    dev = like.device
    return (recv[prev].to(dev) if prev is not None else None,
            recv[nxt].to(dev) if nxt is not None else None)
