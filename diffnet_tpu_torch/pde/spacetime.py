"""Space-time formulations on a 2D (x, t) grid, the y axis being time
(port of ``diffnet_tpu/pde/spacetime.py``).

  * :class:`SpaceTimeHeat`: parabolic heat as 2D FEM with SUPG in time,
      R_i = ∫ N_i u_t + nu ∫ N_i,x u_x + tau ∫ N_i,t u_t
            - ∫ (N_i + tau N_i,t) f,
    the initial condition a Dirichlet row at t = 0 (bc1, values ``u0``),
    the side walls Dirichlet-0 (bc2);
  * :class:`AllenCahnIceMelt`: the reaction G(u) = 2 D A (u - 3u^2 + 2u^3)
    - D k with Cn^2 interface diffusion;
  * :class:`BurgersSpaceTime`: the strong form mean_el sum_gp gpw (u_t +
    u u_x [- visc u_xx] [- f])^2 on a deg-2 basis.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import FEM2DModule
from .poisson import _buffer, _squeeze_field

__all__ = ["SpaceTimeHeat", "AllenCahnIceMelt", "BurgersSpaceTime"]


class _SpaceTimeMixin:
    """The initial-condition field ``u0`` (kwarg, the dataset's, or zeros)
    and the optional manufactured source ``forcing(x, t)`` at the Gauss
    points, as buffers."""

    def _setup_spacetime(self, dataset, kwargs, with_u0=True):
        if with_u0:
            u0 = kwargs.get("u0", getattr(dataset, "u0",
                                          np.zeros(self.node_shape)))
            self.register_buffer("u0", _buffer(u0), persistent=False)
        forcing = kwargs.get("forcing", None)
        self.register_buffer(
            "f_gp", _buffer(None if forcing is None
                            else forcing(self.xgp, self.ygp)),
            persistent=False)
        self.exact_solution = kwargs.get("exact_solution", None)

    def apply_bcs(self, u, inputs_tensor):
        """The initial row (bc1, from ``u0``) and the walls (bc2, 0)
        substituted into the field."""
        u = _squeeze_field(u)
        u = torch.where(inputs_tensor[..., 1] > 0.5, self.u0.to(u.dtype), u)
        return self.apply_dirichlet(u, inputs_tensor[..., 2], 0.0)


class SpaceTimeHeat(_SpaceTimeMixin, FEM2DModule):
    """Space-time heat. ``tau``: ``"pe"`` (default, the Peclet-weighted
    ``1 / (2 / h_t + 4 nu / h_x^2)``, which keeps O(h^2)), ``"reference"``
    (DiffNet's ``h_t / 2``) or a number. ``loss_type``: ``"resmin"``
    (``sum R^2``) or ``"energy"`` (the quadratic space-time functional)."""

    def __init__(self, network=None, dataset=None, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self.diffusivity = float(
            kwargs.get("diffusivity", getattr(dataset, "diffusivity", 0.1)))
        tau_mode = kwargs.get("tau", "pe")
        if tau_mode == "reference":
            self.tau = 1.0 / (2.0 / self.hy)
        elif tau_mode == "pe":
            self.tau = 1.0 / (2.0 / self.hy
                              + 4.0 * self.diffusivity / self.hx**2)
        else:
            self.tau = float(tau_mode)
        self._setup_spacetime(dataset, kwargs)
        self.loss_type = kwargs.get("loss_type", "resmin")

    def residual(self, u, f_gp, bc1, bc2):
        nu, tau = self.diffusivity, self.tau
        gp = self.gp_all(u, ("dx", "dy"))   # dy is d/dt
        r = gp["dy"] - f_gp.expand_as(gp["dy"])
        R = self.assemble_multi([(r, "N"), (nu * gp["dx"], "dx"),
                                 (tau * r, "dy")])
        R = torch.where(bc2 > 0.5, torch.zeros_like(R), R)
        return torch.where(bc1 > 0.5, torch.zeros_like(R), R)

    @property
    def batch_reduction(self) -> str:
        """The energy is a mean; resmin sums R^2 over the batch."""
        return "mean" if self.loss_type == "energy" else "sum"

    def loss(self, u, inputs_tensor, forcing_tensor):
        u = self.apply_bcs(u, inputs_tensor)
        if self.f_gp is not None:
            f_gp = self.f_gp.to(u.dtype)
        else:
            f_gp = self.gauss_pt_evaluation(_squeeze_field(forcing_tensor))
        if self.loss_type == "energy":
            gp = self.gp_all(u, ("N", "dx", "dy"))
            res = (gp["N"] * gp["dy"] + self.diffusivity * gp["dx"] ** 2
                   + self.tau * gp["dy"] ** 2
                   - 2.0 * (gp["N"] + self.tau * gp["dy"]) * f_gp)
            return torch.mean(torch.sum(self.basis.gpw(u.dtype) * res, -1))
        R = self.residual(u, f_gp, inputs_tensor[..., 1],
                          inputs_tensor[..., 2])
        return torch.sum(R**2)


class AllenCahnIceMelt(_SpaceTimeMixin, FEM2DModule):
    """Allen-Cahn ice melt in space-time. Constants ``ac_A``, ``ac_Cn``,
    ``ac_D``, ``ac_k`` (kwargs, else the dataset's, else 16, 0.1, 1, 2);
    an optional ``forcing`` adds ``-∫ N f`` for manufactured solutions."""

    def __init__(self, network=None, dataset=None, **kwargs):
        super().__init__(network, dataset, **kwargs)
        for name, default in (("ac_A", 16.0), ("ac_Cn", 0.1), ("ac_D", 1.0),
                              ("ac_k", 2.0)):
            setattr(self, name, float(kwargs.get(
                name, getattr(dataset, name, default))))
        self._setup_spacetime(dataset, kwargs)

    def calcG(self, u_gp):
        """The reaction at the Gauss points. With ``ac_A == 0`` the double
        well is dropped from the expression, not multiplied by 0, so the
        residual stays affine in u (the homotopy's first stage solves it
        as a linear system)."""
        lin = -self.ac_D * self.ac_k * torch.ones_like(u_gp)
        if self.ac_A == 0.0:
            return lin
        return (2.0 * self.ac_D * self.ac_A
                * (u_gp - 3.0 * u_gp**2 + 2.0 * u_gp**3) + lin)

    def residual(self, u, bc1, bc2):
        D, Cn = self.ac_D, self.ac_Cn
        gp = self.gp_all(u, ("N", "dx", "dy"))
        G_gp = self.calcG(gp["N"])
        if self.f_gp is not None:
            G_gp = G_gp - self.f_gp.to(u.dtype) / D
        R = self.assemble_multi([
            (gp["dy"] + D * G_gp, "N"),
            (D * Cn**2 * gp["dx"], "dx"),
            (D * Cn**2 * gp["dy"], "dy")])
        R = torch.where(bc1 > 0.5, torch.zeros_like(R), R)
        return torch.where(bc2 > 0.5, torch.zeros_like(R), R)

    # the loss sums squared residuals over the batch
    batch_reduction = "sum"

    def loss(self, u, inputs_tensor, forcing_tensor):
        u = self.apply_bcs(u, inputs_tensor)
        R = self.residual(u, inputs_tensor[..., 1], inputs_tensor[..., 2])
        return torch.sum(R**2)


class BurgersSpaceTime(_SpaceTimeMixin, FEM2DModule):
    """Space-time Burgers, deg 2 by default: loss = mean_el sum_gp gpw
    (u_t + u u_x [- viscosity u_xx] [- f])^2. Inputs (x, bc1, bc2,
    bc1_val), the masks -10 off the boundary: the initial row takes bc1_val,
    the walls 0."""

    def __init__(self, network=None, dataset=None, viscosity=0.0, **kwargs):
        kwargs.setdefault("fem_basis_deg", 2)
        super().__init__(network, dataset, **kwargs)
        self.viscosity = float(viscosity)
        self._setup_spacetime(dataset, kwargs, with_u0=False)

    def apply_bcs(self, u, inputs_tensor):
        u = _squeeze_field(u)
        u = torch.where(inputs_tensor[..., 1] > 0.5, inputs_tensor[..., 3], u)
        return torch.where(inputs_tensor[..., 2] > 0.5, torch.zeros_like(u),
                           u)

    def loss(self, u, inputs_tensor, forcing_tensor):
        u = self.apply_bcs(u, inputs_tensor)
        quants = ("N", "dx", "dy") + (("d2x",) if self.viscosity else ())
        gp = self.gp_all(u, quants)
        res = gp["dy"] + gp["N"] * gp["dx"]
        if self.viscosity:
            res = res - self.viscosity * gp["d2x"]
        if self.f_gp is not None:
            res = res - self.f_gp.to(u.dtype)
        return torch.mean(torch.sum(self.basis.gpw(u.dtype) * res**2, -1))
