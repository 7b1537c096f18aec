"""2D and 3D Poisson / diffusion (port of ``diffnet_tpu/pde/poisson.py``).

Losses, as in the JAX package:
  * energy minimisation (Ritz), ``loss_type="energy"`` (the default);
  * Galerkin residual minimisation, ``loss_type="resmin"``, in the
    element-tensor stencil form (``residual_formulation="et"``, deg-1
    default) or the Gauss-point pipeline (``"gp"``), with an optional dense
    left preconditioner;
  * strong-form collocation via FEM second derivatives,
    ``loss_type="strong"`` (needs deg >= 2);
  * the mixed first-order strong form over (u, mx, my),
    :class:`PoissonTwoDof2D`, and the FDM strong form,
    :class:`PoissonFDM2D`.

``fused_kernels=True`` routes the deg-1 losses through the CUDA kernels of
:mod:`diffnet_tpu_torch.ops`: 2D energy and resmin (K3, K1), 3D resmin
(K5, the trilinear stiffness action); ``fused_loss_grad=True`` the 2D
resmin loss through the single-launch loss-and-gradient kernel (K2). The
JAX package's TPU kernel variants (``fused_variant``) are not carried over.

Every loss takes ``(u, inputs, forcing)`` where ``inputs`` stacks
channels-last masks ``[..., (nu, bc1, bc2)]``: bc1 nodes take
``bc1_value``, bc2 nodes ``bc2_value`` (or ``u_bc`` when given).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import fem
from ..ops.poisson_energy import poisson_energy_fused
from ..ops.poisson_loss_grad import poisson_resmin_loss_fused
from ..ops.poisson_residual import poisson_residual_fused
from ..ops.poisson_residual_3d import poisson_residual_fused_3d
from ..parallel.mesh import all_reduce_sum, block_bounds, halo_exchange
from .base import FDMModule, FEM2DModule, FEM3DModule

__all__ = [
    "poisson_energy_loss",
    "poisson_energy_loss_split",
    "poisson_resmin_residual",
    "poisson_resmin_residual_et",
    "poisson_strong_form_loss",
    "Poisson2D",
    "Poisson3D",
    "PoissonFDM2D",
    "PoissonTwoDof2D",
]


def _squeeze_field(u):
    """Accept ``[B, ..., 1]`` network outputs and ``[B, ...]`` fields."""
    if u.shape[-1] == 1 and u.ndim >= 3:
        return u[..., 0]
    return u


def _buffer(x):
    """A module constant as a float32 tensor (None stays None)."""
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x, np.float32))


def _grads(nsd: int) -> tuple[str, ...]:
    return ("dx", "dy", "dz")[:nsd]


def poisson_energy_loss(module, u, nu, f, w):
    """Ritz energy: ``sum_gp w (0.5 nu |grad u|^2 - u f)`` per element, then
    the mean over elements and batch."""
    grads = _grads(module.nsd)
    gp = module.gp_all(u, ("N",) + grads)
    nu_gp = module.gauss_pt_evaluation(nu)
    f_gp = module.gauss_pt_evaluation(f)
    grad2 = sum(gp[q] ** 2 for q in grads)
    res = w * (0.5 * nu_gp * grad2 - gp["N"] * f_gp)
    return torch.mean(torch.sum(res, dim=-1))


def poisson_energy_loss_split(module, u, nu, f, w, mesh):
    """:func:`poisson_energy_loss` of fields split over the 'space' axis of
    `mesh` by :func:`~diffnet_tpu_torch.parallel.block_bounds` along their
    rows (2D, axis -2) or planes (3D, axis -3): u, nu, f this rank's
    blocks ``[B, n_loc, ...]``. Each rank takes one row (plane) of each
    from its next neighbour and sums the terms of the element rows it owns
    (element row e spans node rows e and e + 1: a rank owns those that
    start in its block), so no element counts twice; the sum, all-reduced
    over 'space' (:func:`~diffnet_tpu_torch.parallel.all_reduce_sum`) and
    divided by the global element count times B, is the global mean on
    every rank. Degree-1 elements."""
    if module.basis.deg != 1:
        raise NotImplementedError("the split energy takes degree-1 "
                                  f"elements, not degree {module.basis.deg}")
    axis = u.dim() - module.nsd
    b = block_bounds(module.node_shape[0], mesh.space)
    i = mesh.space_index
    if u.shape[axis] != b[i + 1] - b[i]:
        raise ValueError(f"this rank's block has {u.shape[axis]} of the "
                         f"{module.node_shape[0]} rows; block_bounds gives "
                         f"it {b[i + 1] - b[i]}")
    grown = halo_exchange(torch.stack([u, nu, f]), mesh, 1, axis + 1,
                          zero_edges=False)
    if mesh.space_neighbour(-1) is not None:   # the row before is not ours
        grown = grown.narrow(axis + 1, 1, grown.shape[axis + 1] - 1)
    ub, nub, fb = grown.unbind(0)
    grads = _grads(module.nsd)
    gp = module.gp_all(ub, ("N",) + grads)
    grad2 = sum(gp[q] ** 2 for q in grads)
    res = w * (0.5 * module.gauss_pt_evaluation(nub) * grad2
               - gp["N"] * module.gauss_pt_evaluation(fb))
    n_elements = u.shape[0] * math.prod(s - 1 for s in module.node_shape)
    return all_reduce_sum(res.sum(), mesh) / n_elements


def poisson_resmin_residual(module, u, nu_gp, f_gp, bc_mask):
    """Assembled Galerkin residual ``R_i = ∫ nu grad N_i . grad u - ∫ N_i f``
    with the Dirichlet rows zeroed (Gauss-point pipeline)."""
    grads = _grads(module.nsd)
    gp = module.gp_all(u, grads)
    terms = [(nu_gp * gp[q], q) for q in grads] + [(-f_gp, "N")]
    R = module.assemble_multi(terms)
    return torch.where(bc_mask > 0.5, torch.zeros_like(R), R)


def poisson_resmin_residual_et(module, u, nu, f_gp, bc_mask):
    """The same residual through the static element tensor (nodal nu, no
    Gauss-point intermediates; the forcing projection folds into the same
    stencil pass)."""
    R = fem.element_action(u, nu, module._poisson_et_tensor, module.basis,
                           module.node_shape, gp_terms=[(-f_gp, "N")])
    return torch.where(bc_mask > 0.5, torch.zeros_like(R), R)


def poisson_strong_form_loss(module, u, nu_gp, f_gp, w):
    """Collocation on the strong form: ``mean_elem sum_gp w (nu lap u +
    f)^2`` (needs deg >= 2)."""
    seconds = ("d2x", "d2y", "d2z")[:module.nsd]
    gp = module.gp_all(u, seconds)
    lap = sum(gp[q] for q in seconds)
    res = w * (nu_gp * lap + f_gp) ** 2
    return torch.mean(torch.sum(res, dim=-1))


class _PoissonCommon:
    """Losses and boundary handling shared by :class:`Poisson2D` and
    :class:`Poisson3D`.

    MMS convenience: ``exact_solution(x, y[, z])`` and ``forcing(x, y[,
    z])`` callables precompute ``f_gp`` at the Gauss points and, with
    ``mms_dirichlet=True``, the Dirichlet data ``u_bc`` at the nodes."""

    def _setup_poisson(self, **kwargs):
        self.loss_type = kwargs.get("loss_type", "energy")
        default_form = "et" if self.basis.deg == 1 else "gp"
        self.residual_formulation = kwargs.get("residual_formulation",
                                               default_form)
        if self.residual_formulation not in ("et", "gp"):
            raise ValueError(
                f"residual_formulation must be 'et' or 'gp', got "
                f"{self.residual_formulation!r}")
        if self.residual_formulation == "et":
            self._poisson_et_tensor = fem.element_tensor(self.basis.basis,
                                                         _grads(self.nsd))
        self.energy_weighting = kwargs.get("energy_weighting", "jxw")
        self.fused_kernels = bool(kwargs.get("fused_kernels", False))
        self.fused_loss_grad = bool(kwargs.get("fused_loss_grad", False))
        if self.fused_loss_grad and not (
                self.fused_kernels and self.nsd == 2
                and self.loss_type == "resmin"
                and kwargs.get("precond", None) is None):
            raise ValueError(
                "fused_loss_grad requires fused_kernels=True, nsd=2, "
                "loss_type='resmin' and no precond")
        if self.fused_kernels:
            supported = (self.basis.deg == 1 and self.ngp_1d == 2
                         and ((self.nsd == 2
                               and self.loss_type in ("energy", "resmin"))
                              or (self.nsd == 3
                                  and self.loss_type == "resmin")))
            if not supported:
                raise ValueError(
                    "fused_kernels supports deg-1 2-GP 2D energy/resmin and "
                    "3D resmin only")
            if self.loss_type == "energy" and self.energy_weighting != "jxw":
                raise ValueError(
                    "fused_kernels energy path is jxw-weighted only")
        self.bc1_value = kwargs.get("bc1_value", 1.0)
        self.bc2_value = kwargs.get("bc2_value", 0.0)
        self.exact_solution = kwargs.get("exact_solution", None)
        forcing = kwargs.get("forcing", None)
        u_bc = kwargs.get("u_bc", None)
        if kwargs.get("mms_dirichlet", False) and self.exact_solution:
            u_bc = self.exact_solution(*self.node_coords_all())
        # Dirichlet field on bc2 nodes (instead of bc2_value), the Gauss-
        # point forcing, and a dense left preconditioner [N, N] on vec(R)
        self.register_buffer("u_bc", _buffer(u_bc), persistent=False)
        self.register_buffer(
            "f_gp", _buffer(None if forcing is None
                            else forcing(*self.gp_coords_all())),
            persistent=False)
        self.register_buffer("precond", _buffer(kwargs.get("precond")),
                             persistent=False)

    def _weights(self, dtype):
        if self.energy_weighting == "gpw":
            return self.basis.gpw(dtype)
        return self.basis.jxw(dtype)

    def _substitute_bcs(self, u, bc1, bc2):
        if self.u_bc is not None:
            return torch.where(bc2 > 0.5, self.u_bc.to(u.dtype), u)
        u = self.apply_dirichlet(u, bc1, self.bc1_value)
        return self.apply_dirichlet(u, bc2, self.bc2_value)

    def _f_gp(self, f, dtype):
        if self.f_gp is not None:
            return self.f_gp.to(dtype)
        return self.gauss_pt_evaluation(f)

    def _fused_residual(self, u, nu, f_gp, bc_mask):
        """The masked residual through K1 (2D) or K5 (3D)."""
        Nf = fem.galerkin_project(f_gp, self.basis, "N",
                                  u.shape[-self.nsd:]).contiguous()
        fused = (poisson_residual_fused if self.nsd == 2
                 else poisson_residual_fused_3d)
        return fused(u, nu.contiguous(), Nf, bc_mask, self.basis)

    def apply_bcs(self, u, inputs_tensor):
        return self._substitute_bcs(_squeeze_field(u), inputs_tensor[..., 1],
                                    inputs_tensor[..., 2])

    def residual_for_field(self, u, inputs_tensor, forcing_tensor):
        """Assembled Galerkin residual R(u) of a nodal field: Dirichlet data
        substituted into u, the weak-form assembly, then the rows of all
        substituted nodes (bc1 and bc2) zeroed. Affine in u."""
        u = _squeeze_field(u)
        nu = inputs_tensor[..., 0]
        bc1 = inputs_tensor[..., 1]
        bc2 = inputs_tensor[..., 2]
        u = self._substitute_bcs(u, bc1, bc2)
        bc_mask = bc2 if self.u_bc is not None else torch.maximum(bc1, bc2)
        f_gp = self._f_gp(None if forcing_tensor is None
                          else _squeeze_field(forcing_tensor), u.dtype)
        if self.fused_kernels and self.loss_type == "resmin":
            return self._fused_residual(u, nu, f_gp, bc_mask)
        if self.residual_formulation == "et":
            return poisson_resmin_residual_et(self, u, nu, f_gp, bc_mask)
        return poisson_resmin_residual(
            self, u, self.gauss_pt_evaluation(nu), f_gp, bc_mask)

    @property
    def batch_reduction(self) -> str:
        """resmin sums R^2 over the batch; energy and strong take means."""
        return "sum" if self.loss_type == "resmin" else "mean"

    def loss(self, u, inputs_tensor, forcing_tensor):
        u = _squeeze_field(u)
        nu = inputs_tensor[..., 0]
        bc1 = inputs_tensor[..., 1]
        bc2 = inputs_tensor[..., 2]
        f = _squeeze_field(forcing_tensor)
        u = self._substitute_bcs(u, bc1, bc2)

        if self.loss_type == "energy":
            if self.fused_kernels:
                return poisson_energy_fused(u, nu.contiguous(),
                                            f.contiguous(), self.basis)
            return poisson_energy_loss(self, u, nu, f,
                                       self._weights(u.dtype))

        f_gp = self._f_gp(f, u.dtype)
        if self.loss_type == "resmin":
            if self.fused_loss_grad:
                Nf = fem.galerkin_project(f_gp, self.basis, "N",
                                          u.shape[-2:]).contiguous()
                return poisson_resmin_loss_fused(
                    u, nu.contiguous(), Nf, bc2.contiguous(), self.basis)
            if self.fused_kernels:
                R = self._fused_residual(u, nu, f_gp, bc2)
            elif self.residual_formulation == "et":
                R = poisson_resmin_residual_et(self, u, nu, f_gp, bc2)
            else:
                R = poisson_resmin_residual(
                    self, u, self.gauss_pt_evaluation(nu), f_gp, bc2)
            if self.precond is not None:
                R = R.reshape(R.shape[0], -1) @ self.precond.to(u.dtype).T
            return torch.sum(R**2)
        if self.loss_type == "strong":
            return poisson_strong_form_loss(
                self, u, self.gauss_pt_evaluation(nu), f_gp,
                self._weights(u.dtype))
        raise ValueError(f"unknown loss_type {self.loss_type!r}")


class Poisson2D(_PoissonCommon, FEM2DModule):
    """2D Poisson with energy / resmin / strong loss (see module docstring);
    fields ``[B, y, x]``."""

    def __init__(self, network=None, dataset=None, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self._setup_poisson(**kwargs)


class Poisson3D(_PoissonCommon, FEM3DModule):
    """3D Poisson with energy / resmin / strong loss (see module docstring);
    fields ``[B, z, y, x]``. ``fused_kernels=True`` supports resmin only
    (K5)."""

    def __init__(self, network=None, dataset=None, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self._setup_poisson(**kwargs)


class PoissonTwoDof2D(FEM2DModule):
    """Mixed first-order strong form over (u, mx, my): the flux m = nu
    grad u is a field of its own, so only first derivatives appear (usable
    at deg 1):

        L = mean_e sum_gp gpw [(mx - nu u_x)^2 + (my - nu u_y)^2
                               + (mx_x + my_y + f)^2]

    Dirichlet: u = 1 on bc1, u = 0 on bc2; the flux fields are free.
    ``pred`` is a tuple (u, mx, my) (``DirectField(n_fields=3)``) or a
    stacked ``[..., 3]`` channels-last tensor; inputs (nu, bc1, bc2)."""

    def _split(self, pred):
        if isinstance(pred, (tuple, list)):
            return tuple(_squeeze_field(f) for f in pred)
        return pred[..., 0], pred[..., 1], pred[..., 2]

    def apply_bcs(self, pred, inputs_tensor):
        u, mx, my = self._split(pred)
        u = self.apply_dirichlet(u, inputs_tensor[..., 1], 1.0)
        u = self.apply_dirichlet(u, inputs_tensor[..., 2], 0.0)
        return u, mx, my

    def loss(self, pred, inputs_tensor, forcing_tensor):
        u, mx, my = self.apply_bcs(pred, inputs_tensor)
        nu = inputs_tensor[..., 0]
        f = _squeeze_field(forcing_tensor)
        quants = ("N", "dx", "dy")
        # one contraction for the three fields and three quantities
        allgp = fem.gp_eval_stacked(torch.stack([u, mx, my]), self.basis,
                                    quants)
        ugp, mxgp, mygp = (dict(zip(quants, f.unbind(-2)))
                           for f in allgp.unbind(0))
        nu_gp = self.gauss_pt_evaluation(nu)
        f_gp = self.gauss_pt_evaluation(f)
        w = self.basis.gpw(u.dtype)
        res1 = ((mxgp["N"] - nu_gp * ugp["dx"]) ** 2
                + (mygp["N"] - nu_gp * ugp["dy"]) ** 2)
        res2 = (mxgp["dx"] + mygp["dy"] + f_gp) ** 2
        return torch.mean(torch.sum(w * (res1 + res2), dim=-1))


class PoissonFDM2D(FDMModule):
    """FDM strong-form Poisson: ``res = f + grad u . grad nu + nu lap u``
    on the interior, u = 0 on bc2; the loss is each sample's 2-norm of
    res. 5-point first derivatives shrink the grid by two rings, the 3-point
    laplacian by one: every term is cropped to the common interior."""

    def loss(self, u, inputs_tensor, forcing_tensor):
        u = _squeeze_field(u)
        nu = inputs_tensor[..., 0]
        f = _squeeze_field(forcing_tensor)
        u = self.apply_dirichlet(u, inputs_tensor[..., 2], 0.0)
        fdm = self.fdm
        ux, uy = fdm.dx(u), fdm.dy(u)
        lap = fdm.dxx(u) + fdm.dyy(u)
        nux, nuy = fdm.dx(nu), fdm.dy(nu)
        k1 = (fdm.num_pt - 1) // 2
        m = max(k1, 1)

        def crop(a, k):
            d = m - k
            return a[..., d:a.shape[-2] - d, d:a.shape[-1] - d] if d else a

        res = (f[..., m:-m, m:-m] + crop(ux, k1) * crop(nux, k1)
               + crop(uy, k1) * crop(nuy, k1)
               + nu[..., m:-m, m:-m] * crop(lap, 1))
        return torch.linalg.vector_norm(res.reshape(res.shape[0], -1), dim=1)
