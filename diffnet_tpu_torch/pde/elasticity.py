"""Linear elasticity: FSDT (Mindlin-Reissner) plate bending (port of
``diffnet_tpu/pde/elasticity.py``).

Fields (w, phi_x, phi_y); bending stiffnesses D_11, D_22, D_12, D_66, shear
stiffnesses A_44, A_55 with the correction K_s; moments M_xx, M_yy, M_xy
and shears Q_x, Q_y; three assembled Galerkin residuals:

  R_w   = ∫ grad(N)·(Q_x, Q_y) - ∫ N q
  R_phx = ∫ (N_x M_xx + N_y M_xy + N Q_x)
  R_phy = ∫ (N_x M_xy + N_y M_yy + N Q_y)

zeroed on the clamped nodes (``inputs[..., 3] > 0.5``), where each field
takes its Dirichlet value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fem
from .base import FEM2DModule
from .poisson import _buffer, _squeeze_field

__all__ = ["ElasticFSDT"]


class ElasticFSDT(FEM2DModule):
    """The clamped FSDT plate under a uniform load ``q_load``.
    ``loss_norm``: "frobenius" (the sum of the three residuals' norms) or
    "squared" (the sum of their squared norms)."""

    def __init__(self, network=None, dataset=None, E=1.0, nu_poisson=0.25,
                 thickness=0.1, K_s=1.0, q_load=1.0, **kwargs):
        super().__init__(network, dataset, **kwargs)
        v, h = nu_poisson, thickness
        self.E, self.nu_poisson, self.thickness, self.K_s = E, v, h, K_s
        self.q_load = q_load
        self.D_11 = (E * h**3) / (12 * (1 - v**2))
        self.D_22 = self.D_11
        self.D_12 = (E * v * h**3) / (12 * (1 - v**2))
        self.D_66 = (E * h**3) / (12 * (1 + v))
        self.A_44 = (E * h) / (2 * (1 + v))
        self.A_55 = self.A_44
        zeros = np.zeros(self.node_shape, np.float32)
        for name in ("w_bc", "phi_x_bc", "phi_y_bc"):
            self.register_buffer(name, _buffer(np.asarray(
                kwargs.get(name, zeros), np.float32)), persistent=False)
        self.loss_norm = kwargs.get("loss_norm", "frobenius")

    def _apply_field_bcs(self, pred, inputs):
        bc2 = inputs[..., 3]
        clamped = bc2 > 0.5

        def sub(f, bc_val):
            return torch.where(clamped, bc_val.to(f.dtype), f)

        w, px, py = (_squeeze_field(f) for f in pred)
        return (sub(w, self.w_bc), sub(px, self.phi_x_bc),
                sub(py, self.phi_y_bc), clamped)

    def apply_bcs(self, pred, inputs_tensor):
        w, px, py, _ = self._apply_field_bcs(pred, inputs_tensor)
        return w, px, py

    def calc_residuals(self, pred, inputs_tensor, forcing_tensor):
        w, phi_x, phi_y, clamped = self._apply_field_bcs(pred, inputs_tensor)
        # one stacked contraction for the three fields, split by unbind: a
        # view per quantity would cost a zero-filled copy of the whole in
        # the backward pass
        quants = ("N", "dx", "dy")
        allgp = fem.gp_eval_stacked(torch.stack([w, phi_x, phi_y], 0),
                                    self.basis, quants)
        wgp, pxgp, pygp = (dict(zip(quants, f.unbind(-2)))
                           for f in allgp.unbind(0))

        Q_x = self.K_s * self.A_55 * (pxgp["N"] + wgp["dx"])
        Q_y = self.K_s * self.A_44 * (pygp["N"] + wgp["dy"])
        M_xx = self.D_11 * pxgp["dx"] + self.D_12 * pygp["dy"]
        M_yy = self.D_12 * pxgp["dx"] + self.D_22 * pygp["dy"]
        M_xy = self.D_66 * (pxgp["dy"] + pygp["dx"])
        q = torch.full_like(wgp["N"], self.q_load)

        R1 = self.assemble_multi([(Q_x, "dx"), (Q_y, "dy"), (-q, "N")])
        R2 = self.assemble_multi([(M_xx, "dx"), (M_xy, "dy"), (Q_x, "N")])
        R3 = self.assemble_multi([(M_xy, "dx"), (M_yy, "dy"), (Q_y, "N")])
        z = torch.zeros_like(R1)
        return (torch.where(clamped, z, R1), torch.where(clamped, z, R2),
                torch.where(clamped, z, R3))

    @property
    def batch_reduction(self) -> str | None:
        """The squared norm sums over the batch; the Frobenius loss, a root
        of a sum over the batch, reduces its parts (``"global"``)."""
        return "sum" if self.loss_norm == "squared" else "global"

    def loss_parts(self, pred, inputs_tensor, forcing_tensor) -> list:
        """The three residuals' squared norms."""
        R1, R2, R3 = self.calc_residuals(pred, inputs_tensor, forcing_tensor)
        return [torch.sum(R1**2), torch.sum(R2**2), torch.sum(R3**2)]

    def loss_from_parts(self, parts) -> torch.Tensor:
        if self.loss_norm == "squared":
            return parts[0] + parts[1] + parts[2]
        return sum(torch.sqrt(q + 1e-12) for q in parts)

    def loss(self, pred, inputs_tensor, forcing_tensor):
        return self.loss_from_parts(self.loss_parts(pred, inputs_tensor,
                                                    forcing_tensor))
