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
  and :func:`gather_block` (the global array back from the blocks), both
  by the one partition rule :func:`block_bounds` and both differentiable
  (the scatter and gather that GSPMD inserts where a split stops);
* ``replicated`` -> :func:`replicate` (the first rank's values on every
  rank);
* ``shard_batch`` -> :func:`shard_batch`;
* ``halo_exchange_y`` / ``halo_exchange_z`` -> the same names, an
  autograd function whose backward sends the halo cotangents back and adds
  them into the neighbours' edge rows (the transpose of ``ppermute`` that
  JAX derives by itself); :func:`halo_exchange_transpose` is that backward
  as a function of its own;
* a ``psum`` inside a differentiated function -> :func:`all_reduce_sum`,
  an autograd function (:meth:`Mesh.all_reduce` is the plain collective,
  for the Krylov inner products and the Trainer's gradient sum).

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

__all__ = ["Mesh", "make_mesh", "shard_batch", "block_bounds",
           "block_lengths", "local_block", "gather_block", "spatial_mesh",
           "replicate", "all_reduce_sum", "halo_exchange",
           "halo_exchange_transpose", "halo_exchange_y", "halo_exchange_z"]


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


def block_bounds(n: int, k: int) -> list[int]:
    """The ``k + 1`` bounds of the blocks of `n` slices over `k` ranks, the
    one partition rule of the port's split arrays: rank j holds slices
    ``bounds[j]:bounds[j + 1]``.

    Equal blocks where `k` divides `n`. Otherwise block j starts at
    ``j (n - 1) // k`` and the last block takes the rest: for the ``2^p +
    1`` nodes of a multigrid hierarchy over a power of two of ranks, blocks
    of ``(n - 1) / k`` slices and one more in the last, and then every split
    falls at row a on a level and at row 2a on the level above (the
    transfers of :func:`~diffnet_tpu_torch.train.multigrid_preconditioner`
    need no other rows). Raises ValueError where a block would be empty."""
    if n % k == 0:
        bounds = [j * n // k for j in range(k + 1)]
    else:
        bounds = [j * (n - 1) // k for j in range(k)] + [n]
    if any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
        raise ValueError(f"{n} slices do not split into {k} non-empty "
                         "blocks")
    return bounds


def block_lengths(n_loc: int, mesh: Mesh, mesh_axis: str = "space",
                  device=None) -> list[int]:
    """Every rank's block length along `mesh_axis`, from this rank's
    `n_loc` (one small all-reduce; `device`: the backend's, a card's for
    NCCL)."""
    lens = torch.zeros(mesh.size(mesh_axis), dtype=torch.float64,
                       device=device)
    lens[mesh.index(mesh_axis)] = n_loc
    return [int(v) for v in mesh.all_reduce(lens, mesh_axis).tolist()]


def local_block(x, mesh: Mesh, axis: int = 0, mesh_axis: str = "data"):
    """This rank's block of a global array (numpy or torch) along `axis`:
    the ``index(mesh_axis)``-th of the ``size(mesh_axis)`` blocks of
    :func:`block_bounds` (equal blocks where the axis divides)."""
    bounds = block_bounds(x.shape[axis], mesh.size(mesh_axis))
    i = mesh.index(mesh_axis)
    lo, m = bounds[i], bounds[i + 1] - bounds[i]
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, lo, m)
    return np.take(x, np.arange(lo, lo + m), axis=axis)


def _gather(x, mesh: Mesh, axis: int, mesh_axis: str, sizes: list[int]
            ) -> torch.Tensor:
    """The blocks of `sizes` slices along `axis`, concatenated."""
    m = max(sizes)
    buf = mesh.to_comm(x.contiguous())
    if buf.shape[axis] < m:   # all_gather takes blocks of one shape
        pad = list(buf.shape)
        pad[axis] = m - buf.shape[axis]
        buf = torch.cat([buf, buf.new_zeros(pad)], dim=axis)
    parts = [torch.empty_like(buf) for _ in range(len(sizes))]
    dist.all_gather(parts, buf, group=mesh.axis_group(mesh_axis))
    return torch.cat([p.narrow(axis, 0, s) for p, s in zip(parts, sizes)],
                     dim=axis).to(x.device)


class _GatherBlock(torch.autograd.Function):
    """The global tensor from the ranks' blocks, differentiable: each rank
    backpropagates its share of the global tensor's cotangent (the
    convention of :func:`all_reduce_sum`), so a block's cotangent is the
    sum of the ranks' shares of its slices."""

    @staticmethod
    def forward(x, mesh, axis, mesh_axis, sizes):
        return _gather(x, mesh, axis, mesh_axis, sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.axis, ctx.mesh_axis, ctx.sizes = inputs

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.mesh_axis)
        g = ctx.mesh.all_reduce(g.contiguous(), ctx.mesh_axis)
        return (g.narrow(ctx.axis, sum(ctx.sizes[:i]), ctx.sizes[i]),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, gx, *_):
        return _gather(gx, ctx.mesh, ctx.axis, ctx.mesh_axis, ctx.sizes)


def gather_block(x: torch.Tensor, mesh: Mesh, axis: int = 0,
                 mesh_axis: str = "space", n: int | None = None
                 ) -> torch.Tensor:
    """The global tensor from the blocks of the ranks along `mesh_axis`
    (the inverse of :func:`local_block`), on every one of them. n: the
    global length along `axis`, whose :func:`block_bounds` give the blocks'
    lengths; None gathers the lengths first (one more collective).

    Differentiable in both modes. Its backward sums the ranks' cotangents
    of the global tensor over `mesh_axis` and returns each rank those of
    its own block: every rank backpropagates its share, as through
    :func:`all_reduce_sum`. Its transpose, the scatter of a tensor that
    every rank holds in full, is :func:`local_block` (a ``narrow``, whose
    backward keeps this rank's slices' cotangents and zeros the rest)."""
    k = mesh.size(mesh_axis)
    if k == 1:
        return x
    axis = axis % x.dim()
    if n is None:
        sizes = block_lengths(x.shape[axis], mesh, mesh_axis, x.device)
    else:
        b = block_bounds(int(n), k)
        sizes = [b1 - b0 for b0, b1 in zip(b, b[1:])]
    if x.shape[axis] != sizes[mesh.index(mesh_axis)]:
        raise ValueError(f"gather_block: this rank's block has "
                         f"{x.shape[axis]} slices along axis {axis}, the "
                         f"partition {sizes[mesh.index(mesh_axis)]}")
    return _GatherBlock.apply(x, mesh, axis, mesh_axis, sizes)


def spatial_mesh(mesh: Mesh | None) -> Mesh | None:
    """`mesh` where its 'space' axis has more than one rank, else None: the
    test by which a module takes its split path or the one it takes
    without a mesh."""
    return mesh if mesh is not None and mesh.space > 1 else None


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


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks along a mesh axis, differentiable."""

    @staticmethod
    def forward(x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.axis = inputs

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axis), None, None

    @staticmethod
    def jvp(ctx, gx, _mesh, _axis):
        return ctx.mesh.all_reduce(gx, ctx.axis)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str = "space"
                   ) -> torch.Tensor:
    """The sum of `x` over the ranks along `axis`, on every one of them;
    differentiable in both modes (the tangent is the sum of the tangents).

    The backward follows one convention: **each rank backpropagates its own
    share**. What each rank computes from the sum is one term of a total
    summed over the ranks, so the cotangent of a rank's input is the sum of
    every rank's cotangent of the output: the backward is the same
    all-reduce. That is the convention of the halo exchange's backward too,
    so a loss split over 'space' (each rank's rows' terms) differentiates
    through both. Where every rank computes one replicated value from the
    sum, its backward carries ``size(axis)`` times the value's gradient:
    the Trainer averages such gradients over 'data' (``batch_reduction =
    "global"``). Stack several tensors into one to reduce them in one
    collective."""
    if mesh.size(axis) == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axis)


def _edges(mesh: Mesh, halo: int, zero_edges: bool) -> tuple[int, int]:
    """The slices a grown block gains before and after its own."""
    lo = halo if zero_edges or mesh.space_neighbour(-1) is not None else 0
    hi = halo if zero_edges or mesh.space_neighbour(1) is not None else 0
    return lo, hi


def _grow(x, mesh, halo, axis, zero_edges):
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
    parts = [t for t in (from_prev, x, from_next) if t is not None]
    return torch.cat(parts, dim=axis)


def _shrink(g, mesh, halo, axis, zero_edges):
    """The transpose of :func:`_grow`: the block's own slices of `g`, plus
    the cotangents the neighbours hold of its edge slices."""
    lo, hi = _edges(mesh, halo, zero_edges)
    n = g.shape[axis] - lo - hi
    dx = g.narrow(axis, lo, n).clone()
    prev, nxt = mesh.space_neighbour(-1), mesh.space_neighbour(1)
    # the halo cotangents go back to the slices' owners (a zero-filled
    # edge depends on nothing); the neighbours' cotangents of this block's
    # edge slices come here
    g_prev = g.narrow(axis, 0, halo) if prev is not None else None
    g_next = g.narrow(axis, lo + n, halo) if nxt is not None else None
    to_first, to_last = _swap(mesh, g_prev, g_next, prev, nxt)
    if to_first is not None:
        dx.narrow(axis, 0, halo).add_(to_first)
    if to_last is not None:
        dx.narrow(axis, n - halo, halo).add_(to_last)
    return dx


class _HaloExchange(torch.autograd.Function):
    """Grow a block by `halo` slices of its neighbours along `axis`: the
    slices of the ranks before and after it along 'space'. At a domain edge
    the grown side is zero-filled (``zero_edges``) or left off (the block
    then grows on one side only). Linear: its tangent is the tangent's
    exchange, its backward the transpose."""

    @staticmethod
    def forward(x, mesh, halo, axis, zero_edges):
        return _grow(x, mesh, halo, axis, zero_edges)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.halo, ctx.axis, ctx.zero_edges = inputs

    @staticmethod
    def backward(ctx, g):
        return (_shrink(g, ctx.mesh, ctx.halo, ctx.axis, ctx.zero_edges),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, gx, *_):
        return _grow(gx, ctx.mesh, ctx.halo, ctx.axis, ctx.zero_edges)


def halo_exchange(x: torch.Tensor, mesh: Mesh, halo: int, axis: int,
                  zero_edges: bool = True) -> torch.Tensor:
    """`x` (this rank's block along `axis`) grown by `halo` slices of each
    neighbour along 'space'. With `zero_edges` the domain edges are
    zero-filled, so every block grows by ``2 * halo``; without, a block at
    a domain edge grows on its inner side only. Differentiable in both
    modes (``torch.func.jvp`` too)."""
    axis = axis % x.dim()
    if mesh.space == 1 and not zero_edges:
        return x
    return _HaloExchange.apply(x, mesh, halo, axis, zero_edges)


def halo_exchange_transpose(g: torch.Tensor, mesh: Mesh, halo: int,
                            axis: int, zero_edges: bool = True
                            ) -> torch.Tensor:
    """The adjoint of :func:`halo_exchange`: a grown block's values `g` ->
    this rank's block, its own slices plus what the neighbours hold of its
    edge slices in their grown blocks (one exchange). Not differentiated."""
    axis = axis % g.dim()
    if mesh.space == 1 and not zero_edges:
        return g
    return _shrink(g, mesh, halo, axis, zero_edges)


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
