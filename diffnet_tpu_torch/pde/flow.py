"""Incompressible flow: Stokes (PSPG) and Navier-Stokes (full VMS) (port of
``diffnet_tpu/pde/flow.py``).

Mixed (u, v, p) equal-order Q1 discretisation on the structured grid with
  * PSPG pressure stabilisation (``pspg_param = h^2 Re / 12``) for Stokes,
  * residual-based VMS for NS: tau_m and tau_c from the element metric
    (:func:`calc_tau`, advective field detached), cross terms, Reynolds
    stress and PSPG.

All Gauss-point quantities of (u, v, p) come from one contraction.
Dirichlet rows of the assembled residuals are zeroed. ``fused_kernels=True``
routes the NS residual through K6 (:mod:`diffnet_tpu_torch.ops.ns_residual`,
deg 1, 2x2 Gauss, no body forcing); the JAX package's TPU kernel variants
(``fused_variant``) are not carried over. The round-robin objective
protocol of the Trainer (``num_objectives``, ``objective_loss``,
``objective_param_mask``) makes each field residual an objective.

Fields are ``[B, ny, nx]``; ``inputs[..., (x, y, bc1, bc2, bc3, ...)]``
carries the Dirichlet masks of u (bc1), v (bc2) and p (bc3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fem
from ..ops.ns_residual import (calc_tau, ns_vms_residual_fused,
                               vms_residuals)
from .base import FEM2DModule
from .poisson import _buffer, _squeeze_field

__all__ = ["calc_tau", "StokesNSBase", "StokesMMS", "NavierStokes",
           "FlowWeakFormLDC", "ldc_bcs"]


class StokesNSBase(FEM2DModule):
    """Shared mixed-field residual machinery; subclasses set ``eq_type``.

    Keyword arguments, as in the JAX package: ``Re`` (default the dataset's),
    ``loss_norm`` (``"frobenius"``, the sum of the three residual norms, or
    ``"squared"``), ``momentum_scale`` (``"auto"``: ``h^2 / visco`` when
    visco > h, else 1; or a number), ``fused_kernels``, ``pressure_gauge``
    (``"mean-control"``: the bc3 nodes are a gauge pin; ``"dirichlet"``:
    they carry a real condition), ``u_bc`` / ``v_bc`` / ``p_bc`` (nodal
    Dirichlet data, zero by default), ``forcing(x, y) -> (fx, fy)`` at the
    Gauss points, ``exact_solution``."""

    eq_type = "stokes"

    def __init__(self, network=None, dataset=None, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self.Re = float(kwargs.get("Re", getattr(dataset, "Re", 1.0)))
        self.loss_norm = kwargs.get("loss_norm", "frobenius")
        self.viscosity = 1.0 / self.Re
        # diagonal row scaling of the momentum residuals in the loss: at low
        # Re the viscous rows (~visco/h^2) dwarf the continuity rows (~1/h)
        rs = kwargs.get("momentum_scale", "auto")
        if rs == "auto":
            rs = self.h**2 / self.viscosity if self.viscosity > self.h else 1.0
        self.momentum_scale = float(rs)
        self.fused_kernels = bool(kwargs.get("fused_kernels", False))
        if self.fused_kernels and (self.eq_type != "ns"
                                   or self.basis.deg != 1
                                   or self.ngp_1d != 2
                                   or kwargs.get("forcing") is not None):
            raise ValueError("fused_kernels supports the forcing-free NS "
                             "deg-1 2x2-GP configuration only")
        self.pspg_param = self.h**2 * self.Re / 12.0
        self.pressure_gauge = kwargs.get("pressure_gauge", "mean-control")
        if self.pressure_gauge not in ("mean-control", "dirichlet"):
            raise ValueError("pressure_gauge must be 'mean-control' or "
                             f"'dirichlet', got {self.pressure_gauge!r}")
        zeros = np.zeros(self.node_shape, np.float32)
        for name in ("u_bc", "v_bc", "p_bc"):
            self.register_buffer(name, _buffer(kwargs.get(name, zeros)),
                                 persistent=False)
        forcing = kwargs.get("forcing", None)
        fx = fy = None
        if forcing is not None:
            fx, fy = forcing(self.xgp, self.ygp)
        self.register_buffer("fx_gp", _buffer(fx), persistent=False)
        self.register_buffer("fy_gp", _buffer(fy), persistent=False)
        self.exact_solution = kwargs.get("exact_solution", None)

    # -- helpers ---------------------------------------------------------
    def _apply_field_bcs(self, pred, inputs):
        u, v, p = (_squeeze_field(f) for f in pred)
        bc1 = inputs[..., 2]
        bc2 = inputs[..., 3]
        bc3 = inputs[..., 4]
        u = torch.where(bc1 > 0.5, self.u_bc.to(u.dtype), u)
        v = torch.where(bc2 > 0.5, self.v_bc.to(v.dtype), v)
        p = torch.where(bc3 > 0.5, self.p_bc.to(p.dtype), p)
        return u, v, p, bc1, bc2, bc3

    def apply_bcs(self, pred, inputs_tensor):
        u, v, p, *_ = self._apply_field_bcs(pred, inputs_tensor)
        return u, v, p

    def calc_residuals(self, pred, inputs_tensor, forcing_tensor):
        """The assembled (R1, R2, R3), Dirichlet rows zeroed."""
        visco = self.viscosity
        u_pred, v_pred, p_pred, bc1, bc2, bc3 = self._apply_field_bcs(
            pred, inputs_tensor)
        if self.fused_kernels:
            R1, R2, R3 = ns_vms_residual_fused(
                u_pred.contiguous(), v_pred.contiguous(),
                p_pred.contiguous(), None, None, self.basis, visco)
        else:
            R1, R2, R3 = self._residuals(u_pred, v_pred, p_pred, visco)
        R1 = torch.where(bc1 > 0.5, torch.zeros_like(R1), R1)
        R2 = torch.where(bc2 > 0.5, torch.zeros_like(R2), R2)
        R3 = torch.where(bc3 > 0.5, torch.zeros_like(R3), R3)
        return R1, R2, R3

    def _residuals(self, u_pred, v_pred, p_pred, visco):
        dt = u_pred.dtype
        if self.fx_gp is not None:
            f1, f2 = self.fx_gp.to(dt), self.fy_gp.to(dt)
        else:
            f1 = f2 = torch.zeros((1, 1, 1, self.ngp_total), dtype=dt,
                                  device=u_pred.device)
        # one evaluation for all three fields x all quantities
        quants = ("N", "dx", "dy", "d2x", "d2y")
        allgp = fem.gp_eval_stacked(torch.stack([u_pred, v_pred, p_pred]),
                                    self.basis, quants)
        ugp, vgp, pgp = ({q: allgp[k, ..., i, :]
                          for i, q in enumerate(quants)} for k in range(3))

        if self.eq_type == "stokes":
            R1 = self.assemble_multi([
                (visco * ugp["dx"], "dx"), (visco * ugp["dy"], "dy"),
                (-pgp["N"], "dx"), (-f1, "N")])
            R2 = self.assemble_multi([
                (visco * vgp["dx"], "dx"), (visco * vgp["dy"], "dy"),
                (-pgp["N"], "dy"), (-f2, "N")])
            R3 = self.assemble_multi([
                (ugp["dx"] + vgp["dy"], "N"),
                (self.pspg_param * pgp["dx"], "dx"),
                (self.pspg_param * pgp["dy"], "dy")])
            return R1, R2, R3
        # Galerkin + VMS terms (cross terms, Reynolds stress, PSPG,
        # grad-div): the algebra of K6's plain version
        return vms_residuals(ugp, vgp, pgp, f1, f2, self.basis, visco,
                             self.node_shape)

    def residual_for_field(self, fields, inputs_tensor, forcing_tensor):
        """The assembled mixed residual ``{'u','v','p'} -> {'u','v','p'}``
        for the matrix-free Krylov path (``train/linear.py``). Stokes only:
        its PSPG system is affine in (u, v, p); the NS residual is not (use
        ``train.linear.ns_newton_solve``)."""
        if self.eq_type != "stokes":
            raise ValueError(
                "residual_for_field is the affine linear-solver hook; the "
                f"eq_type={self.eq_type!r} residual is nonlinear in the "
                "fields - use train.linear.ns_newton_solve (Newton-Krylov "
                "over mixed_residual) or the training path")
        return self.mixed_residual(fields, inputs_tensor, forcing_tensor)

    def mixed_residual(self, fields, inputs_tensor, forcing_tensor):
        """Gauge-controlled mixed residual ``{'u','v','p'} ->
        {'u','v','p'}`` for the solver paths.

        ``pressure_gauge='mean-control'``: the bc3 pin is removed from the
        operator (bc3 channel zeroed) and replaced by the rank-one
        mean-control term ``R_p += s * mean(p)``, ``s`` about the pressure
        block's diagonal, which anchors the constant pressure mode at O(1)
        strength; the solvers restore the pinned gauge afterwards by a
        constant shift. ``'dirichlet'``: the bc3 rows stay strong Dirichlet
        and no mean control is added."""
        if self.pressure_gauge == "dirichlet":
            R1, R2, R3 = self.calc_residuals(
                (fields["u"], fields["v"], fields["p"]),
                inputs_tensor, forcing_tensor)
            return {"u": R1, "v": R2, "p": R3}
        inputs_nopin = inputs_tensor.clone()
        inputs_nopin[..., 4] = 0.0
        R1, R2, R3 = self.calc_residuals(
            (fields["u"], fields["v"], fields["p"]),
            inputs_nopin, forcing_tensor)
        p_raw = _squeeze_field(fields["p"])
        s = (self.pspg_param * 8.0 / 3.0
             + (self.hx * self.hy) * (4.0 / 9.0) / self.viscosity)
        R3 = R3 + s * torch.mean(p_raw, dim=(-2, -1), keepdim=True)
        return {"u": R1, "v": R2, "p": R3}

    # -- the round-robin objective protocol: one objective a field residual
    num_objectives = 3

    def objective_loss(self, idx, batch):
        """The norm of residual `idx` (R1, R2 or R3) of `batch`: squared
        with ``loss_norm="squared"``, else its root (no momentum scaling).
        Through K6 with ``fused_kernels``."""
        inputs_tensor, forcing_tensor = batch[0], batch[1]
        R = self.calc_residuals(self.network(inputs_tensor), inputs_tensor,
                                forcing_tensor)[idx]
        if self.loss_norm == "squared":
            return torch.sum(R**2)
        return torch.sqrt(torch.sum(R**2) + 1e-12)

    def objective_param_mask(self, idx):
        """The network parameters objective `idx` updates: ``field_{idx}``
        when the network has one parameter a field (``DirectField(n_fields=
        3)``), None (all of them) for a shared network such as
        ``MultiOutUNet``."""
        names = [n for n, _ in self.network.named_parameters()]
        key = f"field_{idx}"
        if key in names and len(names) == self.num_objectives:
            return (key,)
        return None

    @property
    def batch_reduction(self) -> str | None:
        """The squared norm sums over the batch; the root of a sum over the
        batch does not split over ranks."""
        return "sum" if self.loss_norm == "squared" else None

    def loss(self, pred, inputs_tensor, forcing_tensor):
        R1, R2, R3 = self.calc_residuals(pred, inputs_tensor, forcing_tensor)
        s = self.momentum_scale
        if self.loss_norm == "squared":
            return (torch.sum((s * R1) ** 2) + torch.sum((s * R2) ** 2)
                    + torch.sum(R3**2))

        def norm(R):
            return torch.sqrt(torch.sum(R**2) + 1e-12)

        return norm(s * R1) + norm(s * R2) + norm(R3)


class StokesMMS(StokesNSBase):
    """Stokes with PSPG; MMS exact solution u = sin(pi x) cos(pi y),
    v = -cos(pi x) sin(pi y), p = sin(pi x) sin(pi y)."""

    eq_type = "stokes"

    def __init__(self, network=None, dataset=None, **kwargs):
        pi, sin, cos = np.pi, np.sin, np.cos
        # the viscous part of the MMS forcing scales with visco = 1/Re
        visco = 1.0 / float(kwargs.get("Re", getattr(dataset, "Re", 1.0)))
        kwargs.setdefault("forcing", lambda x, y: (
            visco * 2 * pi**2 * sin(pi * x) * cos(pi * y)
            + pi * sin(pi * y) * cos(pi * x),
            -visco * 2 * pi**2 * sin(pi * y) * cos(pi * x)
            + pi * sin(pi * x) * cos(pi * y),
        ))
        super().__init__(network, dataset, **kwargs)
        x, y = self.xx, self.yy
        self.u_exact = np.sin(pi * x) * np.cos(pi * y)
        self.v_exact = -np.cos(pi * x) * np.sin(pi * y)
        self.p_exact = np.sin(pi * x) * np.sin(pi * y)
        if kwargs.get("mms_dirichlet", True):
            self.u_bc = _buffer(self.u_exact)
            self.v_bc = _buffer(self.v_exact)
            self.p_bc = _buffer(self.p_exact)


class NavierStokes(StokesNSBase):
    """VMS-stabilised steady NS (lid-driven cavity and friends)."""

    eq_type = "ns"


class FlowWeakFormLDC(FEM2DModule):
    """The older single-field squared weak-form NS loss: the mean over
    elements of ``1000 (advection + viscous f - pressure div)^2`` plus a
    divergence / pressure regularisation. Inputs channels: (x, bc1 walls,
    bc2 lid, bc3 pressure pin)."""

    def loss(self, pred, inputs_tensor, forcing_tensor):
        u, v, p = (_squeeze_field(f) for f in pred)
        bc1 = inputs_tensor[..., 1]
        bc2 = inputs_tensor[..., 2]
        bc3 = inputs_tensor[..., 3]
        f = _squeeze_field(forcing_tensor)
        u = self.apply_dirichlet(u, bc1, 0.0)
        u = self.apply_dirichlet(u, bc2, 1.0)
        v = torch.where((bc1 > 0.5) | (bc2 > 0.5), torch.zeros_like(v), v)
        p = self.apply_dirichlet(p, bc3, 0.0)

        ug = self.gp_all(u, ("N", "dx", "dy"))
        vg = self.gp_all(v, ("N", "dx", "dy"))
        pg = self.gp_all(p, ("N", "dx"))
        f_gp = self.gauss_pt_evaluation(f)
        w = self.basis.gpw(u.dtype)

        advec = (ug["N"] * ug["N"] * ug["dx"] + ug["N"] * vg["N"] * ug["dy"]
                 + ug["N"] * vg["N"] * vg["dx"] + vg["N"] * vg["N"] * vg["dy"])
        stokes = (ug["dx"] ** 2 + ug["dy"] ** 2 + vg["dx"] ** 2
                  + vg["dy"] ** 2) * f_gp
        press = pg["N"] * (ug["dx"] + vg["dy"])
        r1 = w * (advec + stokes - press) ** 2
        r2 = w * (press**2 + 0.005 * pg["dx"] ** 2)
        return torch.mean(1000.0 * torch.sum(r1, -1) + torch.sum(r2, -1))


def ldc_bcs(node_shape, lengths=(1.0, 1.0), regularized=True):
    """Lid-driven-cavity Dirichlet data: ``u = 1 - 16 (x - 1/2)^4`` on the
    lid (regularised; 1 otherwise), no-slip elsewhere, pressure pinned at
    node (0, 0). Numpy ``(u_bc, v_bc, p_bc)``."""
    ny, nx = node_shape
    x = np.linspace(0, lengths[0], nx)
    u_bc = np.zeros(node_shape, np.float32)
    u_bc[-1, :] = (1.0 - 16.0 * (x - 0.5) ** 4) if regularized else 1.0
    v_bc = np.zeros(node_shape, np.float32)
    p_bc = np.zeros(node_shape, np.float32)
    return u_bc, v_bc, p_bc
