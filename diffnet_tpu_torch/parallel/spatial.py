"""Spatially sharded Poisson stiffness actions over a process mesh (port of
``diffnet_tpu/parallel/spatial.py``).

The global node grid is split along rows (2D, axis -2) or planes (3D, axis
-3) into ``space`` equal contiguous blocks, one a rank along the mesh's
'space' axis. Element row e touches node rows e and e + 1, so each rank
takes one halo node row (plane) from each neighbour
(:func:`~.mesh.halo_exchange`), recomputes the element rows cut by the
split, and keeps the contributions to its own node rows: assembly needs no
second exchange.

Design: the JAX package pads the domain-edge shards with a zero halo too,
because ``shard_map`` needs blocks of one shape, and then subtracts the
phantom element row that spans the zero halo with an extra XLA strip. With
``torch.distributed`` each rank's block has its own shape, so a rank at a
domain edge takes its one inner halo only: its block has no phantom
element, the kernel's result on it is the unsharded operator's rows, and
no correction is needed. Each function equals the unsharded operator: it
sums the same element terms (pinned by the tests, within 2e-6 x max(1,
max |K u|)).

The functions take and return this rank's block, ``[B, n_loc, nx]`` (2D)
or ``[B, nz_loc, n, n]`` (3D) with ``n_loc = ny / space``; `basis` is the
global grid's. They are differentiable: the stiffness actions' VJPs run
on the halo'd block and the exchange's backward returns the halo
cotangents to their owners. The JAX functions' TPU layout knobs
(``variant``, ``tile_y``, ``tile_z``) have no counterpart.
"""

from __future__ import annotations

import torch

from ..core import fem
from ..ops.poisson_residual import poisson_stiffness_action
from ..ops.poisson_residual_3d import poisson_stiffness_action_3d
from .mesh import Mesh, halo_exchange

__all__ = ["poisson_residual_spatial", "poisson_stiffness_spatial_fused",
           "poisson_stiffness_spatial_fused_3d"]


def _halo_block(u, nu, mesh: Mesh, axis: int, what: str):
    """(u, nu) grown by the neighbours' halo slices along `axis`, the slice
    of this rank's own rows in the grown block, and its length."""
    if u.shape != nu.shape:
        raise ValueError(f"{what}: nu.shape {tuple(nu.shape)} != u.shape "
                         f"{tuple(u.shape)}")
    ub = halo_exchange(u, mesh, 1, axis, zero_edges=False)
    nub = halo_exchange(nu, mesh, 1, axis, zero_edges=False)
    first = 0 if mesh.space_neighbour(-1) is None else 1
    return ub.contiguous(), nub.contiguous(), first, u.shape[axis]


def poisson_residual_spatial(u: torch.Tensor, nu: torch.Tensor,
                             basis: fem.BasisTables, mesh: Mesh
                             ) -> torch.Tensor:
    """This rank's rows of the assembled ``K(nu) u`` by the plain element
    path (Gauss-point evaluation and Galerkin projection) on the halo'd row
    block: u, nu ``[B, n_loc, nx]`` -> ``[B, n_loc, nx]``."""
    ub, nub, first, n = _halo_block(u, nu, mesh, u.dim() - 2,
                                    "poisson_residual_spatial")
    gp = fem.gp_eval(ub, basis, ("dx", "dy"))
    nug = fem.gp_eval(nub, basis, ("N",))["N"]
    R = fem.galerkin_project_multi(
        [(nug * gp["dx"], "dx"), (nug * gp["dy"], "dy")], basis,
        ub.shape[-2:])
    return R.narrow(-2, first, n)


def poisson_stiffness_spatial_fused(u: torch.Tensor, nu: torch.Tensor,
                                    basis: fem.BasisTables, mesh: Mesh
                                    ) -> torch.Tensor:
    """This rank's rows of ``K(nu) u`` through K1
    (:func:`~diffnet_tpu_torch.ops.poisson_stiffness_action`) on the halo'd
    ``[B, n_loc + 1 or 2, nx]`` row block: u, nu ``[B, n_loc, nx]`` ->
    ``[B, n_loc, nx]``."""
    ub, nub, first, n = _halo_block(u, nu, mesh, u.dim() - 2,
                                    "poisson_stiffness_spatial_fused")
    return poisson_stiffness_action(ub, nub, basis).narrow(-2, first, n)


def poisson_stiffness_spatial_fused_3d(u: torch.Tensor, nu: torch.Tensor,
                                       basis: fem.BasisTables, mesh: Mesh
                                       ) -> torch.Tensor:
    """This rank's planes of the 3D ``K(nu) u`` through K5
    (:func:`~diffnet_tpu_torch.ops.poisson_stiffness_action_3d`) on the
    halo'd ``[B, nz_loc + 1 or 2, n, n]`` slab: u, nu ``[B, nz_loc, n, n]``
    -> ``[B, nz_loc, n, n]``."""
    ub, nub, first, n = _halo_block(u, nu, mesh, u.dim() - 3,
                                    "poisson_stiffness_spatial_fused_3d")
    return poisson_stiffness_action_3d(ub, nub, basis).narrow(-3, first, n)
