"""FEM Gauss-point evaluation, Galerkin projection and assembly in torch.

Port of ``diffnet_tpu/core/fem.py``. On a uniform tensor-product mesh,
evaluating a field (and any set of derivatives) at all Gauss points of all
elements is

    patches = gather_elements(u)            # [..., nel*, nbf_total]
    gp_vals = patches @ table.T             # one small contraction

and the adjoint, Galerkin projection of a Gauss-point integrand onto the
nodal test functions, is the transposed contraction followed by
``scatter_elements``.

Layout (as in the JAX package): fields are ``[..., y, x]`` (2D) or
``[..., z, y, x]`` (3D) with any leading batch dims; Gauss-point axes are
appended last, so ``gp_eval`` returns ``[..., nelY, nelX, ngp]``.

The basis tables live in :class:`BasisTables`, an ``nn.Module`` whose
float64 buffers follow the owning module across devices; each use casts
them to the working dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .quadrature import FEMBasis

__all__ = [
    "BasisTables",
    "num_elements",
    "gather_elements",
    "scatter_elements",
    "gp_eval",
    "gp_eval_stacked",
    "galerkin_project",
    "galerkin_project_multi",
    "element_matvec",
    "element_tensor",
    "element_action",
    "gp_coords",
    "gp_eval_1d",
    "dirichlet_zero_rows",
]


class BasisTables(nn.Module):
    """The tables of a :class:`FEMBasis` as (non-persistent) buffers.

    ``basis`` keeps the numpy :class:`FEMBasis` for host-side constants
    (``h``, ``gp_1d``, ``jxw`` ...); :meth:`table` returns a quantity's
    ``[ngp_total, nbf_total]`` table on the buffers' device."""

    def __init__(self, basis: FEMBasis):
        super().__init__()
        self.basis = basis
        for q, t in basis.tables.items():
            self.register_buffer(f"t_{q}", torch.from_numpy(np.array(t)),
                                 persistent=False)
        self.register_buffer("jxw_t", torch.from_numpy(np.array(basis.jxw)),
                             persistent=False)
        self.register_buffer("gpw_t", torch.from_numpy(np.array(basis.gpw)),
                             persistent=False)

    @property
    def deg(self) -> int:
        return self.basis.deg

    @property
    def nsd(self) -> int:
        return self.basis.nsd

    @property
    def ngp_total(self) -> int:
        return self.basis.ngp_total

    @property
    def nbf_total(self) -> int:
        return self.basis.nbf_total

    def table(self, quantity: str, dtype: torch.dtype,
              apply_jxw: bool = False) -> torch.Tensor:
        t = getattr(self, f"t_{quantity}")
        if apply_jxw:
            t = t * self.jxw_t[:, None]
        return t.to(dtype)

    def jxw(self, dtype: torch.dtype) -> torch.Tensor:
        return self.jxw_t.to(dtype)

    def gpw(self, dtype: torch.dtype) -> torch.Tensor:
        return self.gpw_t.to(dtype)


def num_elements(node_shape: Sequence[int], deg: int) -> tuple[int, ...]:
    """Elements per axis for a node grid."""
    return tuple((int(n) - 1) // deg for n in node_shape)


def _strided_slice(u: torch.Tensor, nsd: int, offs: tuple[int, ...],
                   deg: int, nel: tuple[int, ...]) -> torch.Tensor:
    """u[..., o_k : o_k + (nel_k-1)*deg + 1 : deg] over the trailing nsd
    axes."""
    idx = [slice(None)] * (u.ndim - nsd)
    for o, ne in zip(offs, nel):
        idx.append(slice(o, o + (ne - 1) * deg + 1, deg))
    return u[tuple(idx)]


def gather_elements(u: torch.Tensor, deg: int, nsd: int) -> torch.Tensor:
    """Per-element nodal patches: ``[..., (z,) y, x]`` ->
    ``[..., (nelZ,) nelY, nelX, nbf_total]``, local dofs ordered
    IBF = (kbf*nbf_1d + jbf)*nbf_1d + ibf (x fastest)."""
    nel = num_elements(u.shape[-nsd:], deg)
    pieces = [_strided_slice(u, nsd, offs, deg, nel)
              for offs in np.ndindex(*((deg + 1,) * nsd))]
    return torch.stack(pieces, dim=-1)


def scatter_elements(r_elem: torch.Tensor, deg: int, nsd: int,
                     node_shape: Sequence[int]) -> torch.Tensor:
    """Adjoint of :func:`gather_elements`: accumulate per-element,
    per-local-dof values into the nodal array.
    ``[..., (nelZ,) nelY, nelX, nbf_total]`` -> ``[..., node_shape]``."""
    nel = tuple(r_elem.shape[-1 - nsd:-1])
    batch = tuple(r_elem.shape[: -1 - nsd])
    offsets = list(np.ndindex(*((deg + 1,) * nsd)))
    if deg == 1:
        # every local dof writes the contiguous slice [o, o + nel): the
        # assembly is a sum of zero-padded per-dof planes
        total = None
        for lin, offs in enumerate(offsets):
            pad = []
            for o, ns, ne in reversed(list(zip(offs, node_shape, nel))):
                pad += [int(o), int(ns) - int(o) - ne]
            piece = F.pad(r_elem[..., lin], pad)
            total = piece if total is None else total + piece
        return total
    out = r_elem.new_zeros(batch + tuple(int(s) for s in node_shape))
    for lin, offs in enumerate(offsets):
        idx = [slice(None)] * len(batch)
        for o, ne in zip(offs, nel):
            idx.append(slice(o, o + (ne - 1) * deg + 1, deg))
        out[tuple(idx)] += r_elem[..., lin]
    return out


def gp_eval_stacked(u: torch.Tensor, basis: BasisTables,
                    quantities: Sequence[str]) -> torch.Tensor:
    """All requested quantities of `u` at all Gauss points in one
    contraction: ``[..., nel*, len(quantities), ngp_total]``."""
    table = torch.cat([basis.table(q, u.dtype) for q in quantities], dim=0)
    patches = gather_elements(u, basis.deg, basis.nsd)
    out = torch.matmul(patches, table.T)
    return out.reshape(out.shape[:-1] + (len(quantities), basis.ngp_total))


def gp_eval(u: torch.Tensor, basis: BasisTables,
            quantities: Sequence[str] = ("N",)) -> dict[str, torch.Tensor]:
    """Dict view of :func:`gp_eval_stacked`:
    quantity -> ``[..., nel*, ngp]``."""
    stacked = gp_eval_stacked(u, basis, quantities)
    # unbind: one stack in the backward pass, where a view per quantity
    # would scatter each gradient into a zero-filled copy of the whole
    return dict(zip(quantities, stacked.unbind(-2)))


def galerkin_project(integrand_gp: torch.Tensor, basis: BasisTables,
                     quantity: str, node_shape: Sequence[int],
                     apply_jxw: bool = True) -> torch.Tensor:
    """``R[node] = sum_elem sum_gp T_q[gp, bf(node)] * integrand * JxW``,
    the weak-form term ``∫ (d^q N_i) * integrand`` assembled into nodes.
    ``[..., nel*, ngp_total]`` -> ``[..., node_shape]``."""
    t = basis.table(quantity, integrand_gp.dtype, apply_jxw)
    r_elem = torch.matmul(integrand_gp, t)
    return scatter_elements(r_elem, basis.deg, basis.nsd, node_shape)


def galerkin_project_multi(integrands: Sequence[tuple[torch.Tensor, str]],
                           basis: BasisTables, node_shape: Sequence[int],
                           apply_jxw: bool = True) -> torch.Tensor:
    """Sum of several weak-form terms in one contraction and one scatter.
    `integrands` is a sequence of ``(gp_integrand [..., nel*, ngp],
    quantity)`` pairs; the integrands broadcast to a common batch shape."""
    igs = torch.broadcast_tensors(*[ig for ig, _ in integrands])
    big_i = torch.cat(igs, dim=-1)
    big_t = torch.cat([basis.table(q, big_i.dtype, apply_jxw)
                       for _, q in integrands], dim=0)
    r_elem = torch.matmul(big_i, big_t)
    return scatter_elements(r_elem, basis.deg, basis.nsd, node_shape)


def gp_coords(basis: FEMBasis, node_shape: Sequence[int],
              lengths: Sequence[float] | None = None
              ) -> tuple[np.ndarray, ...]:
    """Physical coordinates of every Gauss point, as numpy constants:
    per-axis arrays ``(xgp, ygp[, zgp])`` each ``[(nelZ,) nelY, nelX,
    ngp_total]``. `lengths` overrides the element size implied by
    ``basis.h``."""
    nsd = basis.nsd
    nel = num_elements(node_shape, basis.deg)
    gp = basis.gp_1d
    ngp = basis.ngp_1d
    axes_1d = []
    for d in range(nsd):  # d: 0=x, 1=y, 2=z
        ne = nel[::-1][d]
        h = (lengths[d] / ne) if lengths is not None else basis.h[d]
        starts = np.arange(ne) * h
        axes_1d.append(starts[:, None] + (gp[None, :] + 1.0) * 0.5 * h)

    out = []
    if nsd == 1:
        out.append(axes_1d[0])
    elif nsd == 2:
        nelY, nelX = nel
        xg = np.broadcast_to(axes_1d[0][None, :, None, :],
                             (nelY, nelX, ngp, ngp))
        yg = np.broadcast_to(axes_1d[1][:, None, :, None],
                             (nelY, nelX, ngp, ngp))
        out.append(xg.reshape(nelY, nelX, ngp * ngp))
        out.append(yg.reshape(nelY, nelX, ngp * ngp))
    else:
        nelZ, nelY, nelX = nel
        shp = (nelZ, nelY, nelX, ngp, ngp, ngp)
        xg = np.broadcast_to(axes_1d[0][None, None, :, None, None, :], shp)
        yg = np.broadcast_to(axes_1d[1][None, :, None, None, :, None], shp)
        zg = np.broadcast_to(axes_1d[2][:, None, None, :, None, None], shp)
        out.append(xg.reshape(nelZ, nelY, nelX, ngp**3))
        out.append(yg.reshape(nelZ, nelY, nelX, ngp**3))
        out.append(zg.reshape(nelZ, nelY, nelX, ngp**3))
    return tuple(o.astype(np.float64) for o in out)


def element_matvec(u: torch.Tensor, K_elem: np.ndarray, deg: int, nsd: int,
                   node_shape: Sequence[int]) -> torch.Tensor:
    """Assembled matvec with a constant element matrix
    ``R = sum_e scatter(K_elem @ u_e)``: one patch gather, one
    ``[nbf, nbf]`` contraction, one scatter."""
    patches = gather_elements(u, deg, nsd)
    K = torch.as_tensor(np.asarray(K_elem), dtype=u.dtype, device=u.device)
    return scatter_elements(torch.matmul(patches, K.T), deg, nsd, node_shape)


def element_tensor(basis: FEMBasis,
                   quantities: Sequence[str] = ("dx", "dy")) -> np.ndarray:
    """Static Galerkin element tensor (float64 numpy)
    ``A[c, a, b] = sum_gp jxw[gp] N[gp, c] sum_q T_q[gp, a] T_q[gp, b]``:
    for a coefficient in the nodal basis, the element residual
    ``∫_e nu sum_q (d^q N_a)(d^q u)`` is ``sum_{c,b} A[c,a,b] nu_c u_b``."""
    nbf = basis.nbf_total
    N = basis.tables["N"]
    A = np.zeros((nbf, nbf, nbf), np.float64)
    for q in quantities:
        T = basis.tables[q]
        A += np.einsum("g,gc,ga,gb->cab", basis.jxw, N, T, T, optimize=True)
    return A


def element_action(u: torch.Tensor, coeff: torch.Tensor, A: np.ndarray,
                   basis: BasisTables, node_shape: Sequence[int],
                   gp_terms: Sequence[tuple[torch.Tensor, str]] = ()
                   ) -> torch.Tensor:
    """Assembled action ``R = K(coeff) u`` through the static element tensor
    of :func:`element_tensor`, plus optional weak-form source terms
    ``gp_terms = [(integrand_gp [..., nel*, ngp], quantity), ...]``
    assembled (with JxW) into the same residual. deg-1 grids take the
    stencil expansion (:func:`_element_action_stencil`); higher degrees
    contract the gathered patches."""
    if basis.deg == 1:
        return _element_action_stencil(u, coeff, A, basis, node_shape,
                                       gp_terms)
    nbf = basis.nbf_total
    coeff_e = gather_elements(coeff, basis.deg, basis.nsd)
    u_e = gather_elements(u, basis.deg, basis.nsd)
    Af = torch.as_tensor(np.asarray(A, np.float64).reshape(nbf, nbf * nbf),
                         dtype=u.dtype, device=u.device)
    t1 = torch.matmul(coeff_e, Af)
    t1 = t1.reshape(t1.shape[:-1] + (nbf, nbf))
    r_elem = torch.sum(t1 * u_e[..., None, :], dim=-1)
    out = scatter_elements(r_elem, basis.deg, basis.nsd, node_shape)
    if gp_terms:
        out = out + galerkin_project_multi(gp_terms, basis, node_shape)
    return out


def _element_views(x: torch.Tensor, nsd: int) -> list[torch.Tensor]:
    """deg-1 corner views of a nodal field on the element grid, ordered by
    the linear local-dof id (x fastest)."""
    nel = num_elements(x.shape[-nsd:], 1)
    return [_strided_slice(x, nsd, offs, 1, nel)
            for offs in np.ndindex(*((2,) * nsd))]


def _element_action_stencil(u, coeff, A, basis, node_shape, gp_terms=()):
    """deg-1 :func:`element_action` as one elementwise stencil expression:

        out = sum_a pad_a( sum_{b,c} A[c,a,b] u_view_b coeff_view_c
                           + sum_t sum_g (T_t[g,a] jxw[g]) integrand_t[g] )

    with the 2^nsd corner views on the element grid and pad_a zero-padding
    each local-dof contribution back to node shape."""
    nsd = basis.nsd
    uv = _element_views(u, nsd)
    cv = _element_views(coeff, nsd)
    nbf = basis.nbf_total
    A = np.asarray(A)
    fem_basis = basis.basis
    term_tables = [np.asarray(fem_basis.tables[q] * fem_basis.jxw[:, None])
                   for _, q in gp_terms]
    nel = num_elements(node_shape, 1)
    total = None
    for a, offs in enumerate(np.ndindex(*((2,) * nsd))):
        r_a = None
        for c in range(nbf):
            for b in range(nbf):
                w = float(A[c, a, b])
                if w == 0.0:
                    continue
                term = w * (uv[b] * cv[c])
                r_a = term if r_a is None else r_a + term
        for (integrand, _), table in zip(gp_terms, term_tables):
            for g in range(table.shape[0]):
                term = float(table[g, a]) * integrand[..., g]
                r_a = term if r_a is None else r_a + term
        if r_a is None:
            continue
        pad = []
        for o, ns, ne in reversed(list(zip(offs, node_shape, nel))):
            pad += [int(o), int(ns) - int(o) - ne]
        piece = F.pad(r_a, pad)
        total = piece if total is None else total + piece
    return total


def gp_eval_1d(u_line: torch.Tensor, basis: BasisTables,
               quantities: Sequence[str] = ("N",)
               ) -> dict[str, torch.Tensor]:
    """Surface-trace evaluation: the 1D Gauss-point values of a nodal line
    (a row or column of a 2D field, an edge of a 3D one) by the facet
    tables. ``[..., n]`` -> quantity -> ``[..., nel_1d, ngp_1d]``."""
    fem_basis = basis.basis
    deg = fem_basis.deg
    nel = (u_line.shape[-1] - 1) // deg
    patches = torch.stack([u_line[..., o:o + (nel - 1) * deg + 1:deg]
                           for o in range(deg + 1)], dim=-1)
    table = torch.as_tensor(
        np.concatenate([fem_basis.surf_tables[q] for q in quantities], 0),
        dtype=u_line.dtype, device=u_line.device)
    out = torch.matmul(patches, table.T)
    out = out.reshape(out.shape[:-1] + (len(quantities), fem_basis.ngp_1d))
    return dict(zip(quantities, out.unbind(-2)))


def dirichlet_zero_rows(R: torch.Tensor, bc_mask: torch.Tensor
                        ) -> torch.Tensor:
    """Zero residual entries on Dirichlet nodes (``bc_mask > 0.5``)."""
    return torch.where(bc_mask > 0.5, torch.zeros_like(R), R)
