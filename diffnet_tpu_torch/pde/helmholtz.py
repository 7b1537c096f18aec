"""Helmholtz equation ``-lap u - k^2 u = f`` (port of
``diffnet_tpu/pde/helmholtz.py``).

Galerkin residual ``R_i = ∫ grad N_i . grad u - k^2 ∫ N_i u - ∫ N_i f``,
u = 0 on bc2 (inputs channel 2); the loss is ``sum R^2``. For ``k h`` of
order one the operator is indefinite: solve it with
``module_linear_solve(method="gmres")`` (or ``"bicgstab"``).
"""

from __future__ import annotations

import torch

from .base import FEM2DModule
from .poisson import _buffer, _squeeze_field

__all__ = ["Helmholtz2D"]


class Helmholtz2D(FEM2DModule):
    """2D Helmholtz. ``khh`` is k (a dataset's ``khh`` takes precedence);
    ``forcing(x, y)`` precomputes f at the Gauss points, otherwise the
    forcing tensor is interpolated there."""

    def __init__(self, network=None, dataset=None, khh=0.5, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self.khh = float(getattr(dataset, "khh", khh))
        self.exact_solution = kwargs.get("exact_solution", None)
        forcing = kwargs.get("forcing", None)
        self.register_buffer(
            "f_gp", _buffer(None if forcing is None
                            else forcing(self.xgp, self.ygp)),
            persistent=False)

    def _f_gp(self, forcing_tensor, dtype):
        if self.f_gp is not None:
            return self.f_gp.to(dtype)
        return self.gauss_pt_evaluation(_squeeze_field(forcing_tensor))

    def residual(self, u, f_gp, bc2):
        gp = self.gp_all(u, ("N", "dx", "dy"))
        R = self.assemble_multi([
            (gp["dx"], "dx"), (gp["dy"], "dy"),
            (-self.khh**2 * gp["N"] - f_gp, "N")])
        return torch.where(bc2 > 0.5, torch.zeros_like(R), R)

    def residual_for_field(self, u, inputs_tensor, forcing_tensor):
        """The affine residual map of a nodal field (for
        ``train.linear``)."""
        bc2 = inputs_tensor[..., 2]
        u = self.apply_dirichlet(_squeeze_field(u), bc2, 0.0)
        return self.residual(u, self._f_gp(forcing_tensor, u.dtype), bc2)

    # the loss sums squared residuals over the batch
    batch_reduction = "sum"

    def loss(self, u, inputs_tensor, forcing_tensor):
        return torch.sum(self.residual_for_field(u, inputs_tensor,
                                                 forcing_tensor) ** 2)
