"""Eikonal equation: signed-distance reconstruction from an oriented point
cloud (port of ``diffnet_tpu/pde/eikonal.py``).

Three-part loss for ``|grad u| = 1`` with the zero level on the cloud:

  * the domain residual, a tau-stabilised weak form (tau = 0.25),
      R_i = ∫ tau u (grad N_i . grad u) + (1 + tau) N_i (|grad u|^2 - 1);
    the right-hand side is (1 + tau), as in the JAX package, so the
    converged field has |grad u| = 1 (DiffNet's N_i alone gives
    ~1/(1 + tau));
  * the zero level, ``sum_p u(p)^2`` over the cloud;
  * the normal alignment, ``sum_p (grad u(p) . n_p - 1)^2`` in 2D and the
    component-wise ``sum_p |grad u(p) - n_p|^2`` in 3D.

Point values come from :mod:`diffnet_tpu_torch.core.interp`. The batch is
``(cloud [B, Np, >= 2 nsd], forcing)`` with columns (x, y[, z], nx, ny[,
nz], ...).
"""

from __future__ import annotations

import torch

from ..core.fdm import make_fdm
from ..core.geometry import occupancy_from_cloud, occupancy_from_cloud_3d
from ..core.interp import grid_interp_2d, grid_interp_3d
from ..utils.device import resolve_device
from .base import FEM2DModule, FEM3DModule
from .poisson import _squeeze_field

__all__ = ["signed_occupancy_init", "Eikonal2D", "Eikonal3D",
           "eikonal_gn_residual", "EikonalFDM2D"]


def signed_occupancy_init(points, normals, areas, grid_shape, scale=0.1):
    """A signed start for direct-field eikonal solves: ``+scale`` outside,
    ``-scale`` inside, from the winding-number occupancy of the cloud
    (tensors ``[B, Np, nsd]``, ``[B, Np, nsd]``, ``[B, Np]``); 2D or 3D by
    ``len(grid_shape)``. Returns ``[B, *grid_shape]``."""
    occ = (occupancy_from_cloud if len(grid_shape) == 2
           else occupancy_from_cloud_3d)
    chi = occ(points, normals, areas, grid_shape)
    return scale * (1.0 - 2.0 * chi)


class _EikonalMixin:
    def _setup_eikonal(self, tau, sdf_weight, normals_weight, kwargs):
        self.tau = float(tau)
        self.sdf_weight = float(sdf_weight)
        self.normals_weight = float(normals_weight)
        self.exact_solution = kwargs.get("exact_solution", None)

    def _h(self):
        return (self.hx, self.hy) if self.nsd == 2 else (self.hx, self.hy,
                                                          self.hz)

    def interp(self, u, points):
        """Values and gradients of the nodal field at the points."""
        fn = grid_interp_2d if self.nsd == 2 else grid_interp_3d
        return fn(u, points, self._h(), deg=self.fem_basis_deg)

    def domain_residual(self, u):
        """The assembled tau-stabilised eikonal residual of a nodal
        field."""
        tau = self.tau
        grads = ("dx", "dy", "dz")[:self.nsd]
        gp = self.gp_all(u, ("N",) + grads)
        grad2 = sum(gp[q] ** 2 for q in grads)
        return self.assemble_multi(
            [(tau * gp["N"] * gp[q], q) for q in grads]
            + [((1.0 + tau) * (grad2 - 1.0), "N")])

    # a root of a sum over the whole batch: the loss reduces its parts
    batch_reduction = "global"

    def loss_parts(self, u, cloud, forcing_tensor) -> list:
        """The squared norm of the domain residual, of u on the cloud and
        of the normals' misalignment (sums over the batch)."""
        nsd = self.nsd
        u = _squeeze_field(u)
        normals = cloud[..., nsd:2 * nsd]
        R1 = self.domain_residual(u)
        u_pts, grad_pts = self.interp(u, cloud[..., 0:nsd])
        if nsd == 2:
            normals_loss = torch.sum(
                (torch.sum(grad_pts * normals, -1) - 1.0) ** 2)
        else:
            normals_loss = torch.sum((grad_pts - normals) ** 2)
        return [torch.sum(R1**2), torch.sum(u_pts**2), normals_loss]

    def loss_from_parts(self, parts) -> torch.Tensor:
        return (torch.sqrt(parts[0] + 1e-12) + self.sdf_weight * parts[1]
                + self.normals_weight * parts[2])

    def loss(self, u, cloud, forcing_tensor):
        return self.loss_from_parts(self.loss_parts(u, cloud,
                                                    forcing_tensor))


class Eikonal2D(_EikonalMixin, FEM2DModule):
    """2D signed-distance reconstruction (see the module docstring)."""

    def __init__(self, network=None, dataset=None, tau=0.25,
                 sdf_weight=1.0, normals_weight=1.0, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self._setup_eikonal(tau, sdf_weight, normals_weight, kwargs)


class Eikonal3D(_EikonalMixin, FEM3DModule):
    """3D signed-distance reconstruction: the 2D loss with the z terms and
    the component-wise normal term."""

    def __init__(self, network=None, dataset=None, tau=0.25,
                 sdf_weight=1.0, normals_weight=1.0, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self._setup_eikonal(tau, sdf_weight, normals_weight, kwargs)


def eikonal_gn_residual(module, cloud, device="cuda"):
    """The least-squares residual of an eikonal module (2D or 3D) for
    :func:`~diffnet_tpu_torch.train.linear.gauss_newton_solve`: the
    assembled domain residual, the cloud's zero-level and its
    normal-alignment equations, weighted by the square roots of the
    module's weights (the terms of ``loss`` with the square root taken per
    equation). `cloud` is ``[1, Np, >= 2 nsd]``; the module and the cloud
    are moved to `device`. Returns ``r(u)`` for a nodal field ``u`` on
    `device`, a dict of tensors:

        r = eikonal_gn_residual(m, cloud, device)
        u, info = gauss_newton_solve(r, u0, lm=1e-4, device=device)
    """
    device = resolve_device(device, "eikonal_gn_residual")
    module.to(device)
    nsd = module.nsd
    c = torch.as_tensor(cloud, dtype=torch.float32).to(device)
    pts, normals = c[..., 0:nsd], c[..., nsd:2 * nsd]
    sw = float(module.sdf_weight) ** 0.5
    nw = float(module.normals_weight) ** 0.5

    def residual(u):
        R1 = module.domain_residual(u[None])[0]
        u_pts, grad_pts = module.interp(u[None], pts)
        if nsd == 2:
            na = nw * (torch.sum(grad_pts[0] * normals[0], -1) - 1.0)
        else:
            na = nw * (grad_pts[0] - normals[0]).reshape(-1)
        return {"domain": R1, "zero_level": sw * u_pts[0], "normals": na}

    return residual


class EikonalFDM2D(Eikonal2D):
    """FDM variant: ``R1 = |grad u|^2 - 1`` by 3-point stencils in "full"
    mode, its mean square over the grid, plus the cloud terms (the normal
    term component-wise). Square unit domains only: the stencils' scale
    assumes unit-length axes of equal node counts."""

    def __init__(self, network=None, dataset=None, **kwargs):
        super().__init__(network, dataset, **kwargs)
        if (self.domain_sizeX != self.domain_sizeY
                or (self.domain_lengthX, self.domain_lengthY) != (1.0, 1.0)):
            raise ValueError("EikonalFDM2D supports square unit domains "
                             "(the FDM stencil scale assumes them)")
        self.fdm = make_fdm(2, self.domain_sizeX)

    def loss_parts(self, u, cloud, forcing_tensor) -> list:
        """The sum of R1^2 over the batch's nodes and their count, and the
        cloud terms' sums."""
        u = _squeeze_field(u)
        normals = cloud[..., 2:4]
        ux = self.fdm.dx(u, mode="full")
        uy = self.fdm.dy(u, mode="full")
        R1 = ux**2 + uy**2 - 1.0
        u_pts, grad_pts = self.interp(u, cloud[..., 0:2])
        normals_loss = (
            torch.sum((grad_pts[..., 0] - normals[..., 0]) ** 2)
            + torch.sum((grad_pts[..., 1] - normals[..., 1]) ** 2))
        return [torch.sum(R1**2), R1.new_tensor(float(R1.numel())),
                torch.sum(u_pts**2), normals_loss]

    def loss_from_parts(self, parts) -> torch.Tensor:
        return (parts[0] / parts[1] + self.sdf_weight * parts[2]
                + self.normals_weight * parts[3])

    def loss(self, u, cloud, forcing_tensor):
        return self.loss_from_parts(self.loss_parts(u, cloud,
                                                    forcing_tensor))
