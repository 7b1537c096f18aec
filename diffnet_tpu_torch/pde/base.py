"""PDE module base classes (port of ``diffnet_tpu/pde/base.py``).

A :class:`PDEModule` is an ``nn.Module`` that owns the network (for example
:class:`~diffnet_tpu_torch.models.field.DirectField`), the FEM tables as
buffers, and the loss:

    u, inputs, forcing = module(batch)        # network forward
    l = module.loss(u, inputs, forcing)       # the PDE-defining loss
    module.training_loss(batch)               # mean of loss(forward(batch))

The Trainer (:mod:`diffnet_tpu_torch.train`) owns the update loop.

Layout, as in the JAX package: batches are channels-last ``[B, (z,) y, x,
C]``, fields ``[B, (z,) y, x]``, Gauss-point arrays ``[..., (nelZ,) nelY,
nelX, ngp]``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import fem
from ..core.fdm import make_fdm
from ..core.quadrature import make_basis

__all__ = ["PDEModule", "FEM2DModule", "FEM3DModule", "FDMModule"]


class PDEModule(nn.Module):
    """Base PDE module. Keyword arguments as in the JAX package: ``nsd``,
    ``batch_size``, ``learning_rate``, ``domain_size(s)``,
    ``domain_length(s)``, ``remat`` (recompute the forward pass and the
    loss in the backward pass instead of keeping their activations)."""

    def __init__(self, network: nn.Module | None = None, dataset=None,
                 **kwargs):
        super().__init__()
        self.network = network
        self.dataset = dataset
        self.kwargs = kwargs
        self.nsd = kwargs.get("nsd", 2)
        self.batch_size = kwargs.get("batch_size", 64)
        self.learning_rate = kwargs.get("learning_rate", 3e-4)
        self.remat = bool(kwargs.get("remat", False))
        self.domain_length = kwargs.get("domain_length", 1.0)
        self.domain_size = kwargs.get("domain_size", 64)
        lengths = kwargs.get("domain_lengths", (self.domain_length,) * 3)
        sizes = kwargs.get("domain_sizes", (self.domain_size,) * 3)
        self.domain_lengths_nd = tuple(lengths)
        self.domain_sizes_nd = tuple(int(s) for s in sizes)
        self.domain_lengthX, self.domain_lengthY = lengths[0], lengths[1]
        self.domain_sizeX, self.domain_sizeY = sizes[0], sizes[1]
        if self.nsd >= 3:
            self.domain_lengthZ, self.domain_sizeZ = lengths[2], sizes[2]

    def loss(self, u, inputs_tensor, forcing_tensor):
        raise NotImplementedError

    @property
    def batch_reduction(self) -> str | None:
        """How :meth:`training_loss` combines a batch's samples, which
        data-parallel training needs (``Trainer.fit`` over a loader on a
        data mesh): ``"mean"`` (the mean of equal row blocks' losses is the
        batch's, the default: a mean of per-sample or batch-mean terms),
        ``"sum"`` (their sum is), ``"global"`` (neither, e.g. a root of a
        sum over the whole batch: the module gives the sums the loss is
        made of (:meth:`training_parts`) and the loss of them
        (:meth:`loss_from_parts`), and the Trainer sums the parts over
        'data' first) or None (no data-parallel training)."""
        return "mean"

    def loss_parts(self, u, inputs_tensor, forcing_tensor) -> list:
        """The sums over the batch that a ``"global"`` loss is made of."""
        raise NotImplementedError

    def loss_from_parts(self, parts) -> torch.Tensor:
        """The ``"global"`` loss of its parts (summed over the batch)."""
        raise NotImplementedError

    def training_parts(self, batch) -> torch.Tensor:
        """The stacked :meth:`loss_parts` of ``forward(batch)``: for a
        ``"global"`` loss, ``training_loss(batch)`` is
        ``loss_from_parts(training_parts(batch))``. With ``remat`` under
        ``torch.utils.checkpoint``."""
        return self._remat(self._training_parts, batch)

    def _training_parts(self, batch) -> torch.Tensor:
        return torch.stack(self.loss_parts(*self(batch)))

    def forward(self, batch):
        """``u = network(inputs)``; returns ``(u, inputs, forcing)``."""
        inputs_tensor, forcing_tensor = batch
        return self.network(inputs_tensor), inputs_tensor, forcing_tensor

    def training_loss(self, batch) -> torch.Tensor:
        """Mean of ``loss(forward(batch))``: what the Trainer minimises.
        With ``remat`` the whole of it runs under
        ``torch.utils.checkpoint``."""
        return self._remat(self._training_loss, batch)

    def _training_loss(self, batch) -> torch.Tensor:
        u, inputs_tensor, forcing_tensor = self(batch)
        return torch.mean(self.loss(u, inputs_tensor, forcing_tensor))

    def _remat(self, fn, batch) -> torch.Tensor:
        """``fn(batch)``, checkpointed when ``remat`` is set: its saved
        tensors are recomputed in the backward pass."""
        if self.remat:
            return checkpoint(fn, batch, use_reentrant=False)
        return fn(batch)

    @staticmethod
    def apply_dirichlet(u, mask, value):
        """``where(mask > 0.5, value, u)``: immersed/Dirichlet masking."""
        if not isinstance(value, torch.Tensor):
            value = float(value)
        return torch.where(mask > 0.5, value, u)

    def apply_bcs(self, u, inputs_tensor):
        """The BC-substituted solution field; identity by default."""
        return u


class _FEMMixin:
    """Shared FEM setup: element counts, spacings, the basis tables (as the
    ``basis`` submodule), Gauss-point and nodal coordinates."""

    def _setup_fem(self, **kwargs):
        self.fem_basis_deg = kwargs.get("fem_basis_deg", 1)
        deg = self.fem_basis_deg
        axes = [("X", self.domain_sizeX), ("Y", self.domain_sizeY)]
        if self.nsd == 3:
            axes.append(("Z", self.domain_sizeZ))
        for name, size in axes:
            if (size - 1) % deg:
                raise ValueError(
                    f"domain_size{name}={size} incompatible with "
                    f"fem_basis_deg={deg}: need (size-1) % deg == 0")
        self.nbf_1d = deg + 1
        self.nbf_total = self.nbf_1d**self.nsd
        self.nelemX = int((self.domain_sizeX - 1) / deg)
        self.nelemY = int((self.domain_sizeY - 1) / deg)
        self.hx = self.domain_lengthX / self.nelemX
        self.hy = self.domain_lengthY / self.nelemY
        h = [self.hx, self.hy]
        if self.nsd == 3:
            self.nelemZ = int((self.domain_sizeZ - 1) / deg)
            self.hz = self.domain_lengthZ / self.nelemZ
            h.append(self.hz)
        self.nelem = self.nelemX
        self.h = self.hx
        self.basis = fem.BasisTables(make_basis(
            self.nsd, deg, h=tuple(h), ngp_1d=kwargs.get("ngp_1d")))
        fem_basis = self.basis.basis
        self.ngp_1d = fem_basis.ngp_1d
        self.ngp_total = fem_basis.ngp_total
        self.gpw = fem_basis.gpw          # [ngp_total] (numpy)
        self.jxw = fem_basis.jxw          # [ngp_total] (numpy)
        node_shape = (self.domain_sizeY, self.domain_sizeX)
        if self.nsd == 3:
            node_shape = (self.domain_sizeZ,) + node_shape
        self.node_shape = node_shape
        coords = fem.gp_coords(fem_basis, node_shape)
        self.xgp, self.ygp = coords[0], coords[1]
        lin = [np.linspace(0, self.domain_lengthX, self.domain_sizeX),
               np.linspace(0, self.domain_lengthY, self.domain_sizeY)]
        if self.nsd == 2:
            self.xx, self.yy = np.meshgrid(*lin)
        else:
            self.zgp = coords[2]
            lin.append(np.linspace(0, self.domain_lengthZ, self.domain_sizeZ))
            self.zz, self.yy, self.xx = np.meshgrid(lin[2], lin[1], lin[0],
                                                    indexing="ij")

    def gp_coords_all(self) -> tuple[np.ndarray, ...]:
        """The Gauss-point coordinate arrays ``(xgp, ygp[, zgp])``."""
        if self.nsd == 3:
            return self.xgp, self.ygp, self.zgp
        return self.xgp, self.ygp

    def node_coords_all(self) -> tuple[np.ndarray, ...]:
        """The nodal coordinate grids ``(xx, yy[, zz])``."""
        if self.nsd == 3:
            return self.xx, self.yy, self.zz
        return self.xx, self.yy

    def gp_all(self, u, quantities: Sequence[str]):
        """Several derivative quantities of `u` in one contraction:
        ``[..., y, x]`` -> dict of ``[..., nelY, nelX, ngp_total]``."""
        return fem.gp_eval(u, self.basis, quantities)

    def gauss_pt_evaluation(self, u):
        return fem.gp_eval(u, self.basis, ("N",))["N"]

    def gauss_pt_evaluation_der_x(self, u):
        return fem.gp_eval(u, self.basis, ("dx",))["dx"]

    def gauss_pt_evaluation_der_y(self, u):
        return fem.gp_eval(u, self.basis, ("dy",))["dy"]

    def gauss_pt_evaluation_der_z(self, u):
        return fem.gp_eval(u, self.basis, ("dz",))["dz"]

    def gauss_pt_evaluation_der2_x(self, u):
        return fem.gp_eval(u, self.basis, ("d2x",))["d2x"]

    def gauss_pt_evaluation_der2_y(self, u):
        return fem.gp_eval(u, self.basis, ("d2y",))["d2y"]

    def gauss_pt_evaluation_der2_z(self, u):
        return fem.gp_eval(u, self.basis, ("d2z",))["d2z"]

    def gauss_pt_evaluation_der2_xy(self, u):
        return fem.gp_eval(u, self.basis, ("d2xy",))["d2xy"]

    def gauss_pt_evaluation_der2_yz(self, u):
        return fem.gp_eval(u, self.basis, ("d2yz",))["d2yz"]

    def gauss_pt_evaluation_der2_zx(self, u):
        return fem.gp_eval(u, self.basis, ("d2zx",))["d2zx"]

    def gauss_pt_evaluation_surf(self, u_line, quantities=("N",)):
        """Facet-trace Gauss evaluation of a 1D nodal line
        (:func:`~diffnet_tpu_torch.core.fem.gp_eval_1d`)."""
        return fem.gp_eval_1d(u_line, self.basis, quantities)

    def assemble(self, integrand_gp, quantity="N", apply_jxw=True):
        """Galerkin-project a Gauss-point integrand onto the test functions
        and scatter it into the nodal residual."""
        return fem.galerkin_project(integrand_gp, self.basis, quantity,
                                    self.node_shape, apply_jxw=apply_jxw)

    def assemble_multi(self, integrands, apply_jxw=True):
        """Assemble a sum of ``(gp_integrand, quantity)`` weak-form terms in
        one contraction and one scatter."""
        return fem.galerkin_project_multi(integrands, self.basis,
                                          self.node_shape,
                                          apply_jxw=apply_jxw)

    def jxw_c(self, dtype=torch.float32) -> torch.Tensor:
        """JxW ``[ngp_total]`` on the module's device."""
        return self.basis.jxw(dtype)

    def calc_l2_err(self, u_sol, exact_solution: Callable | None = None,
                    verbose: bool = False):
        """Quadrature L2 norms of (u_sol - exact), u_sol and exact;
        `exact_solution` takes Gauss-point coordinate arrays (x, y[, z]).
        Returns ``(eL2, uL2, u_exL2)`` as 0-dim tensors."""
        ex = exact_solution or self.exact_solution
        u_gp = self.gauss_pt_evaluation(u_sol)
        u_ex_gp = torch.as_tensor(np.asarray(ex(*self.gp_coords_all())),
                                  dtype=u_sol.dtype, device=u_sol.device)
        jxw = self.jxw_c(u_sol.dtype)

        def norm(g):
            return torch.sqrt(torch.sum(g**2 * jxw))

        eL2, uL2, u_exL2 = norm(u_gp - u_ex_gp), norm(u_gp), norm(u_ex_gp)
        if verbose:
            print(f"||u_sol||, ||uex|| = {float(uL2)}, {float(u_exL2)}")
            print(f"||e||_L2 = {float(eL2)}")
        return eL2, uL2, u_exL2


class FEM2DModule(_FEMMixin, PDEModule):
    """2D FEM PDE base."""

    def __init__(self, network=None, dataset=None, **kwargs):
        kwargs.setdefault("nsd", 2)
        super().__init__(network, dataset, **kwargs)
        if self.nsd != 2:
            raise ValueError(f"FEM2DModule needs nsd=2, got {self.nsd}")
        self._setup_fem(**kwargs)


class FEM3DModule(_FEMMixin, PDEModule):
    """3D FEM PDE base: fields ``[B, z, y, x]``."""

    def __init__(self, network=None, dataset=None, **kwargs):
        kwargs.setdefault("nsd", 3)
        super().__init__(network, dataset, **kwargs)
        if self.nsd != 3:
            raise ValueError(f"FEM3DModule needs nsd=3, got {self.nsd}")
        self._setup_fem(**kwargs)


class FDMModule(PDEModule):
    """FDM PDE base: ``ktype`` and ``stencil_len`` choose the stencils of
    ``fdm`` (:func:`~diffnet_tpu_torch.core.fdm.make_fdm` on
    ``domain_size`` nodes); the ``derivative_*`` methods evaluate them in
    "full" mode (edge padding and boundary correction, the field's
    shape)."""

    def __init__(self, network=None, dataset=None, **kwargs):
        kwargs.setdefault("nsd", 2)
        super().__init__(network, dataset, **kwargs)
        self.ktype = kwargs.get("ktype", "fdm")
        self.stencil_len = kwargs.get("stencil_len", 3)
        self.fdm = make_fdm(self.nsd, self.domain_size, ktype=self.ktype,
                            num_pt=self.stencil_len)

    def derivative_x(self, g):
        return self.fdm.dx(g, mode="full")

    def derivative_y(self, g):
        return self.fdm.dy(g, mode="full")

    def derivative_z(self, g):
        return self.fdm.dz(g, mode="full")

    def derivative_xx(self, g):
        return self.fdm.dxx(g, mode="full")

    def derivative_yy(self, g):
        return self.fdm.dyy(g, mode="full")

    def derivative_zz(self, g):
        return self.fdm.dzz(g, mode="full")

    def calc_laplacian(self, g):
        return self.fdm.laplacian(g, mode="full")
