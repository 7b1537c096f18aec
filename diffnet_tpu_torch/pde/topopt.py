"""Topology optimisation (SIMP) on the Poisson compliance problem (port of
``diffnet_tpu/pde/topopt.py``).

Joint (u, rho) optimisation with three objectives:
  0. the PDE loss: the energy with test function v = u and boundary
     penalties;
  1. the compliance: ``-∫ u f`` ("reference"), or ``-E(u, nu)``
     ("variational", the form whose design gradient is the SIMP
     sensitivity);
  2. the volume fraction: ``(sum(nu) - target)^2``.
The density is projected by ``nu = median3x3(0.001 + sigmoid(rho)^3)``.

``objective(idx)`` serves the Trainer's round-robin protocol; ``optimize``
runs the alternating scheme to a design: an exact CG state solve (every
matvec through K1, :func:`~diffnet_tpu_torch.ops.poisson_residual.
stiffness_action`), a normalised step on the sensitivity, and an exact
volume projection.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fem
from ..ops.poisson_residual import stiffness_action
from ..train.krylov import cg
from ..utils.device import resolve_device
from .base import FEM2DModule
from .poisson import _squeeze_field

__all__ = ["TopOpt2D", "median_filter_3x3"]


def median_filter_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median with edge replication; x: ``[..., H, W]``.

    The median is element 4 of a stable sort of the nine values in the
    JAX package's patch order, not ``torch.median``: where values tie
    (every patch of a uniform design) JAX sends the whole gradient to that
    one element, and ``torch.median``'s backward spreads it over the tied
    ones."""
    H, W = x.shape[-2:]
    rows = torch.arange(-1, H + 1, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=x.device).clamp(0, W - 1)
    xp = x[..., rows, :][..., cols]
    patches = torch.stack([xp[..., i:i + H, j:j + W]
                           for i in range(3) for j in range(3)], dim=-1)
    return torch.sort(patches, dim=-1, stable=True).values[..., 4]


class TopOpt2D(FEM2DModule):
    """Tri-objective topology optimisation.

    ``compliance_form`` selects objective 1:
      * "reference": ``-∫ u f``, which has no gradient in the design (nu
        enters only through the PDE, which the alternating scheme never
        differentiates through);
      * "variational": ``-E(u, nu)``. At the PDE optimum the compliance is
        ``C = ∫ f u = -2 E*``, so maximising the energy over nu descends
        the compliance (dE/dnu = 0.5 |grad u|^2, the SIMP sensitivity)
        while objective 0 keeps u at the optimum."""

    def __init__(self, network=None, dataset=None, target_vf=0.4,
                 weights=(1.0, 1.0, 1e-4), compliance_form="reference",
                 **kwargs):
        super().__init__(network, dataset, **kwargs)
        self.target_vf = float(target_vf)
        self.target_vf_sum = target_vf * self.domain_sizeX * self.domain_sizeY
        self.weights = weights
        if compliance_form not in ("reference", "variational"):
            raise ValueError(f"unknown compliance_form {compliance_form!r}")
        self.compliance_form = compliance_form

    def project_density(self, rho):
        """SIMP projection: ``median3x3(0.001 + sigmoid(rho)^3)``."""
        return median_filter_3x3(0.001 + torch.sigmoid(rho) ** 3)

    def pde_loss(self, u, nu, bc1, bc2, f):
        dbc1 = torch.mean(bc1 * (u - 1.0) ** 2)
        dbc2 = torch.mean(bc2 * u**2)
        gp = self.gp_all(u, ("N", "dx", "dy"))
        nu_gp = self.gauss_pt_evaluation(nu)
        f_gp = self.gauss_pt_evaluation(f)
        w = self.basis.gpw(u.dtype)
        res = w * (0.5 * nu_gp * (gp["dx"] ** 2 + gp["dy"] ** 2)
                   - gp["N"] * f_gp)
        return torch.mean(torch.sum(res, -1)) + dbc1 + dbc2

    def compliance(self, u, nu, bc1, bc2, f):
        u = self.apply_dirichlet(u, bc1, 1.0)
        u = self.apply_dirichlet(u, bc2, 0.0)
        u_gp = self.gauss_pt_evaluation(u)
        f_gp = self.gauss_pt_evaluation(f)
        w = self.basis.gpw(u.dtype)
        return torch.mean(torch.sum(-w * u_gp * f_gp, -1))

    def vf_loss(self, nu):
        return (torch.sum(nu) / max(1, nu.shape[0])
                - self.target_vf_sum) ** 2

    def _unpack(self, pred, inputs_tensor, forcing_tensor):
        u, rho = pred
        u = _squeeze_field(u)
        nu = self.project_density(_squeeze_field(rho))
        return (u, nu, inputs_tensor[..., 0], inputs_tensor[..., 1],
                _squeeze_field(forcing_tensor))

    # -- the round-robin objective protocol -------------------------------
    num_objectives = 3

    def objective_loss(self, idx, batch):
        inputs_tensor, forcing_tensor = batch[0], batch[1]
        return self.objective(idx, self.network(inputs_tensor),
                              inputs_tensor, forcing_tensor)

    def objective(self, idx, pred, inputs_tensor, forcing_tensor):
        u, nu, bc1, bc2, f = self._unpack(pred, inputs_tensor, forcing_tensor)
        if idx == 0:
            return self.pde_loss(u, nu, bc1, bc2, f)
        if idx == 1:
            if self.compliance_form == "variational":
                return -self.pde_loss(u, nu, bc1, bc2, f)
            return self.compliance(u, nu, bc1, bc2, f)
        return self.vf_loss(nu)

    def objective_param_mask(self, idx):
        """The parameters objective `idx` updates: objective 0 (the PDE)
        the state ``u``, objectives 1 and 2 the design ``rho``, for a
        network with parameters so named; None (all) for a shared network,
        which the "variational" form refuses: there objective 1
        (-pde_loss) would move the same parameters as objective 0
        (+pde_loss), a tug-of-war that makes no progress."""
        names = {n for n, _ in self.network.named_parameters()}
        if {"u", "rho"} <= names:
            return ("u",) if idx == 0 else ("rho",)
        if self.compliance_form == "variational":
            raise ValueError(
                "compliance_form='variational' needs a network with "
                "parameters named 'u' and 'rho'; use "
                "compliance_form='reference' for a shared network")
        return None

    def loss(self, pred, inputs_tensor, forcing_tensor):
        u, nu, bc1, bc2, f = self._unpack(pred, inputs_tensor, forcing_tensor)
        w0, w1, w2 = self.weights
        return (w0 * self.pde_loss(u, nu, bc1, bc2, f)
                + w1 * self.compliance(u, nu, bc1, bc2, f)
                + w2 * self.vf_loss(nu))

    # -- the alternating optimisation ---------------------------------------
    @torch.no_grad()
    def vf_projection_shift(self, rho, iters=50):
        """The exact minimiser of objective 2 along the uniform direction:
        bisect a scalar shift s so that mean(project_density(rho + s)) hits
        the target volume fraction. The bounds stay on the device: no host
        read inside the loop."""
        lo = torch.full((), -14.0, dtype=rho.dtype, device=rho.device)
        hi = torch.full((), 14.0, dtype=rho.dtype, device=rho.device)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            above = torch.mean(self.project_density(rho + mid)) \
                > self.target_vf
            lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
        return rho + 0.5 * (lo + hi)

    def optimize(self, inputs, forcing, n_outer=120, lr=1.0, cg_iters=200,
                 device="cuda"):
        """Alternating tri-objective topology optimisation to a design:

          obj0 (PDE):        solve K(nu(rho)) u = F by CG (tol 1e-8) from
                             the last state, every matvec through K1; the
                             energy is quadratic in u, so the solve is the
                             objective-0 update run to convergence;
          obj1 (compliance): a normalised steepest-descent step on
                             -E(u, rho) at the solved state, the exact
                             compliance gradient by self-adjointness;
          obj2 (vf):         the exact volume projection
                             (:meth:`vf_projection_shift`).

        inputs: ``[ny, nx, >=2]`` channels (channel 1 the sink mask);
        forcing: ``[ny, nx(, 1)]``. Runs on `device` (the card unless
        ``device="cpu"``). Returns ``(rho, u, compliance_history)``: rho
        and u as tensors on the device, the history ``∫ f u`` a numpy
        array, one entry an outer iteration."""
        dev = resolve_device(device, "TopOpt2D.optimize")
        self.to(dev)
        basis = self.basis
        node_shape = self.node_shape
        inputs = torch.as_tensor(np.asarray(inputs), dtype=torch.float32,
                                 device=dev)
        sink = inputs[..., 1] > 0.5
        f = _squeeze_field(torch.as_tensor(np.asarray(forcing),
                                           dtype=torch.float32, device=dev))
        F = fem.galerkin_project(self.gauss_pt_evaluation(f), basis, "N",
                                 node_shape)
        F = torch.where(sink, 0.0, F)

        def solve_u(rho, u0):
            nu = self.project_density(rho)[None].contiguous()

            def K(u):
                u_in = torch.where(sink, 0.0, u)
                R = stiffness_action(u_in[None], nu, basis)[0]
                return torch.where(sink, u, R)

            u, _ = cg(K, F, x0=u0, maxiter=cg_iters, tol=1e-8)
            return torch.where(sink, 0.0, u)

        jxw = basis.jxw(torch.float32)

        def sensitivity(rho, u):
            with torch.enable_grad():
                r = rho.detach().requires_grad_(True)
                nu = self.project_density(r)
                gp = fem.gp_eval(u, basis, ("dx", "dy"))
                nu_gp = fem.gp_eval(nu, basis, ("N",))["N"]
                neg_energy = -torch.sum(
                    jxw * 0.5 * nu_gp * (gp["dx"] ** 2 + gp["dy"] ** 2))
                return torch.autograd.grad(neg_energy, r)[0]

        rho = torch.zeros(node_shape, device=dev)
        u = torch.zeros(node_shape, device=dev)
        history = []
        for _ in range(n_outer):
            u = solve_u(rho, u)
            g = sensitivity(rho, u)
            g = g / (g.abs().max() + 1e-12)
            rho = self.vf_projection_shift(rho - lr * g)
            history.append(torch.sum(u * F))   # the compliance ∫ f u
        hist = (torch.stack(history).cpu().numpy().astype(np.float64)
                if history else np.zeros(0))
        return rho, u, hist
