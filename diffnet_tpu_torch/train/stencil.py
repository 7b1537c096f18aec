"""Assembled-stencil form of linear grid operators (port of
``diffnet_tpu/train/stencil.py``).

Every deg-1 Galerkin residual on a nodal tensor-product grid is a width-3
variable-coefficient stencil

    (A u)[p] = sum_{k in {-1,0,1}^nsd} C_k[p] * u[p + k]

(deg-d elements couple d+1 nodes per axis: width 2d+1). The coefficient
field C (``width**nsd`` planes, one per offset) is recovered exactly from
``width**nsd`` colouring probes: a probe with ones on a stride-``width``
lattice puts exactly one probe node inside each output node's stencil, so
every coefficient lands untangled in some probe's output, and taps outside
the domain extract as 0. An iterative solve then applies C (one pass of
``width**nsd`` multiply-adds, or the K4 kernel) instead of re-running the
element assembly every iteration.

Over a process mesh (``mesh=``; :mod:`diffnet_tpu_torch.parallel`) a field
is split into row blocks (planes in 3D) along the mesh's 'space' axis, and
so is C, as the JAX package shards it (``P(None, 'space', None)``): the
apply exchanges one halo row of u with the neighbours and runs on the
halo'd block (through K4 with ``kernel="cuda"``, as K1-split runs K1),
keeping its own rows; the extraction's probes are the blocks of the global
colouring probes, so each rank keeps its rows of C.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.stencil_apply import stencil_apply, stencil_apply_plain
from ..parallel.mesh import block_lengths, halo_exchange
from ..utils.device import resolve_device
from .krylov import _norm

__all__ = ["extract_stencil", "stencil_matvec", "stencil_diag",
           "extract_verified", "assemble_stencil", "SplitStencil"]

def _offsets(width: int, nsd: int):
    h = (width - 1) // 2
    return [tuple(int(c) - h for c in idx)
            for idx in np.ndindex(*((width,) * nsd))]


def check_kernel(kernel: str | None) -> None:
    """Accept ``kernel=None`` (the plain apply) or ``"cuda"`` (K4); any
    other name, such as the JAX package's TPU variants ``"dma"`` and
    ``"blockspec"``, raises ValueError."""
    if kernel not in (None, "cuda"):
        raise ValueError(f"kernel={kernel!r}: the port has one stencil "
                         "kernel, 'cuda' (the JAX package's TPU variants "
                         "are not ported)")


def _split_origin(mesh, n_loc: int, device) -> tuple[int, int]:
    """(the first global row of this rank's block, the global row count)
    from the blocks' lengths along 'space'."""
    lens = block_lengths(n_loc, mesh, "space", device)
    return sum(lens[:mesh.space_index]), sum(lens)


@torch.no_grad()
def extract_stencil(A: Callable, shape, width: int = 3,
                    nsd: int | None = None, device="cuda",
                    mesh=None) -> torch.Tensor:
    """The full stencil coefficient field of a linear operator.

    A: linear map on float32 fields of ``shape`` on `device` (the card by
        default; leading axes
        of ``shape`` are carried along, e.g. a batch of per-sample
        operators; the stencil acts on the trailing ``nsd`` axes). It is
        called once per probe, ``width**nsd`` times, with one field each.
    width: stencil width per axis (3 for deg-1 elements, 2*deg+1 for deg).
    mesh: a process mesh whose 'space' axis splits the first spatial axis:
        `shape` is this rank's block, `A` maps blocks to blocks (every rank
        calls at once), and the probes are the blocks of the global ones.

    Returns ``C`` ``[width**nsd, *shape]`` on `device`, ``C[m]`` the
    coefficient of offset ``_offsets(width, nsd)[m]`` (this rank's rows
    over a mesh).
    """
    device = resolve_device(device, "extract_stencil")
    shape = tuple(int(s) for s in shape)
    if nsd is None:
        nsd = len(shape)
    spatial = shape[-nsd:]
    # the global index of each block's first row along the split axis
    origin = [0] * nsd
    if mesh is not None and mesh.space > 1:
        origin[0] = _split_origin(mesh, spatial[0], device)[0]

    def lattice(idx):
        return tuple(slice((o - a) % width, None, width)
                     for o, a in zip(idx, origin))

    outs = []
    for idx in np.ndindex(*((width,) * nsd)):
        e = np.zeros(spatial, np.float32)
        e[lattice(idx)] = 1.0
        probe = torch.from_numpy(np.broadcast_to(e, shape).copy()).to(device)
        outs.append(A(probe).detach().cpu().numpy())
    outs = np.stack(outs)

    # C_k[p] = outs[color(p + k)][p], color(q) = ravel(q mod width) on the
    # trailing nsd axes: for each offset, positions in residue class r all
    # read probe (r + k) mod width (host-side strided copies, setup only)
    lead = (slice(None),) * (len(shape) - nsd)
    C = np.zeros((width ** nsd,) + shape, np.float32)
    for m, k in enumerate(_offsets(width, nsd)):
        for r_idx in np.ndindex(*((width,) * nsd)):
            c = 0
            for rc, kc in zip(r_idx, k):
                c = c * width + (rc + kc) % width
            sl = lead + lattice(r_idx)
            C[(m,) + sl] = outs[(c,) + sl]
    return torch.from_numpy(C).to(device)


def stencil_matvec(C: torch.Tensor, u: torch.Tensor, width: int = 3,
                   nsd: int | None = None,
                   kernel: str | None = None) -> torch.Tensor:
    """Apply an extracted stencil: one zero pad of ``u`` plus
    ``width**nsd`` shifted multiply-adds.

    kernel: ``"cuda"`` routes the apply through the K4 kernel
    (:mod:`diffnet_tpu_torch.ops.stencil_apply`; on CPU tensors its plain
    version). Width 3 on 2 or 3 spatial axes; leading axes are collapsed into
    the kernel's batch axis, and a C shared by the batch is read with a
    batch stride of 0. Over a mesh, :class:`SplitStencil` applies C's and
    u's row blocks."""
    if nsd is None:
        nsd = u.ndim
    if kernel is None:
        return stencil_apply_plain(C, u, width=width, nsd=nsd)
    check_kernel(kernel)
    if width != 3 or nsd not in (2, 3):
        raise ValueError(
            "kernel= supports width-3 stencils on 2/3 spatial axes only "
            f"(got width={width}, nsd={nsd}); drop kernel= for the plain "
            "path")
    spatial = tuple(u.shape[-nsd:])
    ub = u.reshape((-1,) + spatial)
    Cb = C.reshape((width ** nsd, -1) + spatial)
    return stencil_apply(Cb, ub, nsd).reshape(u.shape)


class SplitStencil:
    """The apply of an extracted stencil split over a mesh's 'space' axis:
    C ``[width**nsd, *lead, n_loc, ...]`` is this rank's block along the
    first spatial axis. A call takes u's block, exchanges ``(width - 1) /
    2`` halo rows with the neighbours (an edge rank takes its inner halo
    only: the stencil's zero pad is the domain edge), applies the stencil
    to the halo'd block (K4 with ``kernel="cuda"``) and keeps its own rows.
    C's halo rows only feed the halo rows' outputs, which are dropped, so
    C is padded with zero rows once, here, and not exchanged.
    Differentiable in u."""

    def __init__(self, C: torch.Tensor, mesh, width: int = 3,
                 nsd: int | None = None, kernel: str | None = None):
        check_kernel(kernel)
        if nsd is None:
            nsd = C.ndim - 1
        self.mesh, self.width, self.nsd, self.kernel = mesh, width, nsd, kernel
        self.halo = (width - 1) // 2
        axis = C.ndim - nsd
        self.n = C.shape[axis]
        self.first = self.halo if mesh.space_neighbour(-1) is not None else 0
        last = self.halo if mesh.space_neighbour(1) is not None else 0
        pad = list(C.shape)
        parts = []
        for rows in (self.first, 0, last):
            pad[axis] = rows
            parts.append(C.new_zeros(pad) if rows else None)
        parts[1] = C
        self.C = torch.cat([p for p in parts if p is not None],
                           dim=axis).contiguous()

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        axis = u.ndim - self.nsd
        if u.shape[axis] != self.n:
            raise ValueError(f"SplitStencil: u has {u.shape[axis]} rows, "
                             f"C's block {self.n}")
        ub = halo_exchange(u, self.mesh, self.halo, axis, zero_edges=False)
        out = stencil_matvec(self.C, ub.contiguous(), width=self.width,
                             nsd=self.nsd, kernel=self.kernel)
        return out.narrow(axis, self.first, self.n)


def stencil_diag(C: torch.Tensor, width: int = 3,
                 nsd: int | None = None) -> torch.Tensor:
    """Centre (diagonal) coefficient of an extracted stencil: the exact
    operator diagonal."""
    if nsd is None:
        nsd = C.ndim - 1
    h = (width - 1) // 2
    center = 0
    for _ in range(nsd):
        center = center * width + h
    return C[center]


def extract_verified(A: Callable, shape, width: int = 3,
                     nsd: int | None = None, probe=None, want=None,
                     device="cuda", mesh=None):
    """:func:`extract_stencil` plus a one-probe defect check.

    probe/want: an already evaluated field and its image ``A(probe)``
    (skips one operator application); made here when omitted, from
    ``np.random.default_rng(0).standard_normal`` (the JAX package draws it
    from ``jax.random.key(0)``: other numbers, the same role; over a mesh
    this rank's block of the global draw).

    Returns ``(C, defect)``, ``defect`` the relative L2 mismatch of the
    stencil matvec against ``A`` on the probe: above ~1e-4 the operator is
    wider than ``width`` or not a stencil. mesh: as for
    :func:`extract_stencil` (the defect's norms run over the whole field).
    """
    device = resolve_device(device, "extract_verified")
    shape = tuple(int(s) for s in shape)
    if nsd is None:
        nsd = len(shape)
    split = mesh is not None and mesh.space > 1
    C = extract_stencil(A, shape, width=width, nsd=nsd, device=device,
                        mesh=mesh)
    if probe is None:
        full = list(shape)
        axis = len(shape) - nsd
        if split:
            start, full[axis] = _split_origin(mesh, shape[axis], device)
        draw = np.random.default_rng(0).standard_normal(full).astype(
            np.float32)
        if split:
            draw = np.take(draw, np.arange(start, start + shape[axis]),
                           axis=axis)
        probe = torch.from_numpy(np.ascontiguousarray(draw)).to(device)
        want = None
    if want is None:
        want = A(probe)
    if split:
        got = SplitStencil(C, mesh, width, nsd)(probe)
    else:
        got = stencil_matvec(C, probe, width=width, nsd=nsd)
    norm = _norm(mesh)
    return C, float(norm(got - want) / (norm(want) + 1e-30))


def assemble_stencil(residual_fn: Callable, shape, width: int = 3,
                     nsd: int | None = None, verify: bool = True,
                     rtol: float = 1e-4, device="cuda", mesh=None):
    """Assemble an affine residual ``R(u) = A u - b`` into stencil form.

    Returns ``(matvec, b, C)`` with ``matvec(u) == A u`` through
    :func:`stencil_matvec` and ``b = -R(0)``. verify: raise ValueError when
    the stencil's defect on one random field exceeds ``rtol`` (an operator
    wider than ``width``, or not a stencil). mesh: `shape` is this rank's
    block along the mesh's 'space' axis and `residual_fn` maps blocks to
    blocks; `b` and `C` are this rank's rows and `matvec` a
    :class:`SplitStencil`."""
    device = resolve_device(device, "assemble_stencil")
    shape = tuple(int(s) for s in shape)
    if nsd is None:
        nsd = len(shape)
    b = -residual_fn(torch.zeros(shape, device=device))

    def A(u):
        return residual_fn(u) + b

    C, defect = extract_verified(A, shape, width=width, nsd=nsd,
                                 device=device, mesh=mesh)
    if verify and defect > rtol:
        raise ValueError(
            f"operator is not a width-{width} stencil on the trailing "
            f"{nsd} axes (relative defect {defect:.2e}); for deg-d "
            "elements pass width=2*deg+1, and for nonlocal operators "
            "use the matrix-free path")
    if mesh is not None and mesh.space > 1:
        return SplitStencil(C, mesh, width, nsd), b, C

    def matvec(u):
        return stencil_matvec(C, u, width=width, nsd=nsd)

    return matvec, b, C
