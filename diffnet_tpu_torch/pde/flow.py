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

Over a process mesh (``calc_residuals`` / ``mixed_residual`` with
``mesh=``; the JAX package runs these under GSPMD with the fields sharded
``P('data', 'space', None)``, tests/test_parallel.py) the fields and inputs
are this rank's row blocks of the grid. Every Gauss-point quantity of the
deg-1 residual is element-local, so each rank substitutes its rows'
Dirichlet data, takes one halo node row of (u, v, p) from each neighbour
(an edge rank its inner one only), assembles the residuals on the halo'd
block with the whole grid's basis (K6 with ``fused_kernels=True``) and
keeps its own rows; the mean-control gauge's mean of p is the block's sum
all-reduced over 'space' (:func:`~diffnet_tpu_torch.parallel.all_reduce_sum`)
over the grid's node count. The gradients reach the fields through the
exchange's backward and the all-reduce's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fem
from ..ops.ns_residual import (calc_tau, ns_vms_residual_fused,
                               ns_vms_residual_rows_fused, vms_residuals)
from ..parallel.mesh import all_reduce_sum, block_bounds, halo_exchange
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
    def _apply_field_bcs(self, pred, inputs, rows=None):
        """`rows`: ``(first, count)`` of a row block's grid rows (the
        Dirichlet data's rows it takes); None for the whole grid."""
        u, v, p = (_squeeze_field(f) for f in pred)
        bc1 = inputs[..., 2]
        bc2 = inputs[..., 3]
        bc3 = inputs[..., 4]

        def data(d, dtype):
            return (d if rows is None else d.narrow(0, *rows)).to(dtype)

        u = torch.where(bc1 > 0.5, data(self.u_bc, u.dtype), u)
        v = torch.where(bc2 > 0.5, data(self.v_bc, v.dtype), v)
        p = torch.where(bc3 > 0.5, data(self.p_bc, p.dtype), p)
        return u, v, p, bc1, bc2, bc3

    def apply_bcs(self, pred, inputs_tensor):
        u, v, p, *_ = self._apply_field_bcs(pred, inputs_tensor)
        return u, v, p

    def calc_residuals(self, pred, inputs_tensor, forcing_tensor,
                       mesh=None):
        """The assembled (R1, R2, R3), Dirichlet rows zeroed. mesh: the
        fields and inputs are this rank's row blocks along its 'space'
        axis, and so are the residuals (see the module docstring)."""
        visco = self.viscosity
        rows = None
        if mesh is not None and mesh.space > 1:
            rows = self._block_rows(inputs_tensor, mesh)
        u_pred, v_pred, p_pred, bc1, bc2, bc3 = self._apply_field_bcs(
            pred, inputs_tensor, rows)
        if rows is not None:
            R1, R2, R3 = self._split_residuals(u_pred, v_pred, p_pred,
                                               rows[0], mesh)
        elif self.fused_kernels:
            R1, R2, R3 = ns_vms_residual_fused(
                u_pred.contiguous(), v_pred.contiguous(),
                p_pred.contiguous(), None, None, self.basis, visco)
        else:
            R1, R2, R3 = self._residuals(u_pred, v_pred, p_pred, visco)
        R1 = torch.where(bc1 > 0.5, torch.zeros_like(R1), R1)
        R2 = torch.where(bc2 > 0.5, torch.zeros_like(R2), R2)
        R3 = torch.where(bc3 > 0.5, torch.zeros_like(R3), R3)
        return R1, R2, R3

    def _block_rows(self, inputs_tensor, mesh) -> tuple[int, int]:
        """(first grid row, rows) of this rank's block
        (:func:`~diffnet_tpu_torch.parallel.block_bounds`)."""
        ny = self.node_shape[0]
        bounds = block_bounds(ny, mesh.space)
        j = mesh.space_index
        a, n = bounds[j], bounds[j + 1] - bounds[j]
        if inputs_tensor.shape[-3] != n:
            raise ValueError(f"calc_residuals over a mesh: the inputs hold "
                             f"{inputs_tensor.shape[-3]} rows, this rank's "
                             f"block of {ny} {n}")
        return a, n

    def _split_residuals(self, u, v, p, first_row, mesh):
        """The unmasked residuals' rows of this rank's block (grid rows
        from `first_row`) of Dirichlet-substituted fields: one halo row of
        (u, v, p) from each neighbour, the residuals of the halo'd block,
        its own rows."""
        n = u.shape[-2]
        first = 1 if mesh.space_neighbour(-1) is not None else 0
        grown = halo_exchange(torch.stack([u, v, p]), mesh, 1, -2,
                              zero_edges=False)
        uh, vh, ph = (t.contiguous() for t in grown.unbind(0))
        if self.fused_kernels:
            R = ns_vms_residual_rows_fused(uh, vh, ph, None, None,
                                           self.basis, self.viscosity)
        else:
            R = self._residuals(uh, vh, ph, self.viscosity,
                                elem_rows=(first_row - first,
                                           uh.shape[-2] - 1))
        return tuple(t.narrow(-2, first, n) for t in R)

    def _residuals(self, u_pred, v_pred, p_pred, visco, elem_rows=None):
        """The unmasked residuals of whole fields, or of a halo'd row block
        whose element rows are ``elem_rows = (first, count)`` of the
        grid's."""
        dt = u_pred.dtype
        n_shape = tuple(u_pred.shape[-2:])
        if self.fx_gp is not None:
            f1, f2 = self.fx_gp.to(dt), self.fy_gp.to(dt)
            if elem_rows is not None:
                f1, f2 = f1.narrow(-3, *elem_rows), f2.narrow(-3, *elem_rows)
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
            def asm(terms):
                return fem.galerkin_project_multi(terms, self.basis, n_shape)

            R1 = asm([(visco * ugp["dx"], "dx"), (visco * ugp["dy"], "dy"),
                      (-pgp["N"], "dx"), (-f1, "N")])
            R2 = asm([(visco * vgp["dx"], "dx"), (visco * vgp["dy"], "dy"),
                      (-pgp["N"], "dy"), (-f2, "N")])
            R3 = asm([(ugp["dx"] + vgp["dy"], "N"),
                      (self.pspg_param * pgp["dx"], "dx"),
                      (self.pspg_param * pgp["dy"], "dy")])
            return R1, R2, R3
        # Galerkin + VMS terms (cross terms, Reynolds stress, PSPG,
        # grad-div): the algebra of K6's plain version
        return vms_residuals(ugp, vgp, pgp, f1, f2, self.basis, visco,
                             n_shape)

    def residual_for_field(self, fields, inputs_tensor, forcing_tensor,
                           mesh=None):
        """The assembled mixed residual ``{'u','v','p'} -> {'u','v','p'}``
        for the matrix-free Krylov path (``train/linear.py``). Stokes only:
        its PSPG system is affine in (u, v, p); the NS residual is not (use
        ``train.linear.ns_newton_solve``). mesh: as for
        :meth:`mixed_residual`."""
        if self.eq_type != "stokes":
            raise ValueError(
                "residual_for_field is the affine linear-solver hook; the "
                f"eq_type={self.eq_type!r} residual is nonlinear in the "
                "fields - use train.linear.ns_newton_solve (Newton-Krylov "
                "over mixed_residual) or the training path")
        return self.mixed_residual(fields, inputs_tensor, forcing_tensor,
                                   mesh)

    def mixed_residual(self, fields, inputs_tensor, forcing_tensor,
                       mesh=None):
        """Gauge-controlled mixed residual ``{'u','v','p'} ->
        {'u','v','p'}`` for the solver paths.

        ``pressure_gauge='mean-control'``: the bc3 pin is removed from the
        operator (bc3 channel zeroed) and replaced by the rank-one
        mean-control term ``R_p += s * mean(p)``, ``s`` about the pressure
        block's diagonal, which anchors the constant pressure mode at O(1)
        strength; the solvers restore the pinned gauge afterwards by a
        constant shift. ``'dirichlet'``: the bc3 rows stay strong Dirichlet
        and no mean control is added. mesh: the fields, inputs and
        residuals are this rank's row blocks (see the module docstring);
        the mean is over the whole grid."""
        if self.pressure_gauge == "dirichlet":
            R1, R2, R3 = self.calc_residuals(
                (fields["u"], fields["v"], fields["p"]),
                inputs_tensor, forcing_tensor, mesh)
            return {"u": R1, "v": R2, "p": R3}
        inputs_nopin = inputs_tensor.clone()
        inputs_nopin[..., 4] = 0.0
        R1, R2, R3 = self.calc_residuals(
            (fields["u"], fields["v"], fields["p"]),
            inputs_nopin, forcing_tensor, mesh)
        p_raw = _squeeze_field(fields["p"])
        s = (self.pspg_param * 8.0 / 3.0
             + (self.hx * self.hy) * (4.0 / 9.0) / self.viscosity)
        if mesh is not None and mesh.space > 1:
            total = all_reduce_sum(torch.sum(p_raw, dim=(-2, -1),
                                             keepdim=True), mesh, "space")
            mean = total / float(np.prod(self.node_shape))
        else:
            mean = torch.mean(p_raw, dim=(-2, -1), keepdim=True)
        R3 = R3 + s * mean
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
        """The squared norm sums over the batch; the Frobenius loss, a root
        of a sum over the batch, reduces its parts (``"global"``)."""
        return "sum" if self.loss_norm == "squared" else "global"

    def loss_parts(self, pred, inputs_tensor, forcing_tensor) -> list:
        """The three residuals' squared norms (momentum ones scaled)."""
        R1, R2, R3 = self.calc_residuals(pred, inputs_tensor, forcing_tensor)
        s = self.momentum_scale
        return [torch.sum((s * R1) ** 2), torch.sum((s * R2) ** 2),
                torch.sum(R3**2)]

    def loss_from_parts(self, parts) -> torch.Tensor:
        if self.loss_norm == "squared":
            return parts[0] + parts[1] + parts[2]
        return sum(torch.sqrt(q + 1e-12) for q in parts)

    def loss(self, pred, inputs_tensor, forcing_tensor):
        return self.loss_from_parts(self.loss_parts(pred, inputs_tensor,
                                                    forcing_tensor))


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
