"""Advection-diffusion with SUPG stabilisation (port of
``diffnet_tpu/pde/advection.py``).

Weak form with the streamline-upwind test functions ``v + tau a . grad v``:

  R_i = ∫ N_i (a . grad u) + nu ∫ grad N_i . grad u
        + tau ∫ (a . grad N_i)(a . grad u) - ∫ (N_i + tau a . grad N_i) f

with ``tau = 1 / (2 |a| / h + 4 nu / h^2)``; nu is the diffusivity times
the inputs' channel 0 (ones for the bundled datasets). u = bc1_value on
bc1 and 0 on bc2, whose rows are zeroed; the loss is ``sum R^2``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import FEM2DModule
from .poisson import _buffer, _squeeze_field

__all__ = ["AdvDiff2D"]


class AdvDiff2D(FEM2DModule):
    def __init__(self, network=None, dataset=None,
                 adv=(math.cos(math.pi / 6), math.sin(math.pi / 6)),
                 diffusivity=1e-4, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self.adv = np.asarray(adv, np.float64)
        self.adv_mag = float(np.linalg.norm(self.adv))
        self.diffusivity = float(diffusivity)
        self.tau = 1.0 / (2.0 * self.adv_mag / self.h
                          + 4.0 * self.diffusivity / self.h**2)
        forcing = kwargs.get("forcing", None)
        self.register_buffer(
            "f_gp", _buffer(None if forcing is None
                            else forcing(self.xgp, self.ygp)),
            persistent=False)
        self.bc1_value = kwargs.get("bc1_value", 1.0)
        self.exact_solution = kwargs.get("exact_solution", None)

    def residual(self, u, f_gp, bc1, bc2, nu_gp=None):
        ax, ay = float(self.adv[0]), float(self.adv[1])
        nu, tau = self.diffusivity, self.tau
        gp = self.gp_all(u, ("dx", "dy"))
        a_grad_u = ax * gp["dx"] + ay * gp["dy"]
        nu_eff = nu if nu_gp is None else nu * nu_gp
        r = a_grad_u - f_gp.expand_as(a_grad_u)
        R = self.assemble_multi([
            (r, "N"),
            (nu_eff * gp["dx"] + tau * ax * r, "dx"),
            (nu_eff * gp["dy"] + tau * ay * r, "dy")])
        R = torch.where(bc1 > 0.5, torch.zeros_like(R), R)
        return torch.where(bc2 > 0.5, torch.zeros_like(R), R)

    def apply_bcs(self, u, inputs_tensor):
        """The inlet and wall values substituted into the field."""
        u = _squeeze_field(u)
        u = self.apply_dirichlet(u, inputs_tensor[..., 1], self.bc1_value)
        return self.apply_dirichlet(u, inputs_tensor[..., 2], 0.0)

    # the loss sums squared residuals over the batch
    batch_reduction = "sum"

    def loss(self, u, inputs_tensor, forcing_tensor):
        u = self.apply_bcs(u, inputs_tensor)
        if self.f_gp is not None:
            f_gp = self.f_gp.to(u.dtype)
        else:
            f_gp = self.gauss_pt_evaluation(_squeeze_field(forcing_tensor))
        nu_gp = self.gauss_pt_evaluation(inputs_tensor[..., 0])
        R = self.residual(u, f_gp, inputs_tensor[..., 1],
                          inputs_tensor[..., 2], nu_gp=nu_gp)
        return torch.sum(R**2)
