"""Immersed-boundary network (IBN) parametric Poisson (port of
``diffnet_tpu/pde/ibn.py``): ``IBNPoisson2D`` and ``IBNPoisson3D``.

2D, per batch: an oriented boundary cloud -> the generalized winding number
on the node grid -> chi = (w > threshold) -> network(chi), or network(cloud)
for the point-cloud networks -> u -> immersed Dirichlet masking -> the Ritz
energy (weighted by the Gauss weights only, as the reference's IBN), the
Galerkin residual or, for ``'mask'``, the regression of the raw winding
field. Image ensembles, whose chi is a dataset channel, are the same module
with ``source_from='inputs'``. 3D: voxel topologies, chi a dataset channel,
the same energy.

``mesh=`` splits the fields over the 'space' axis of a process mesh, as
the JAX dry run shards them (``P("data", "space", ...)``): the batch's
rows (2D) or depth planes (3D), NHWC axis 1, are this rank's block of
:func:`~diffnet_tpu_torch.parallel.block_bounds` (a
``NumpyLoader(mesh=, space_axis=1)`` yields them), the network takes and
gives the same block (a ``UNet`` or ``UNet3D`` built on the same mesh), the
Dirichlet substitution runs on the block, and the Ritz energy is the
global one on every rank (:func:`~.poisson.poisson_energy_loss_split`).
Only the energy splits: under a 'space' axis of more than one rank the
resmin and mask losses and the winding-number source raise
NotImplementedError. With no mesh, or one 'space' rank, the modules run
the code they run without one.
"""

from __future__ import annotations

import torch

from ..core.geometry import occupancy_from_cloud, winding_grid
from ..parallel.mesh import spatial_mesh
from .base import FEM2DModule, FEM3DModule
from .poisson import (_squeeze_field, poisson_energy_loss,
                      poisson_energy_loss_split, poisson_resmin_residual)

__all__ = ["IBNPoisson2D", "IBNPoisson3D"]


class IBNPoisson2D(FEM2DModule):
    """Parametric immersed-boundary Poisson in 2D.

    source_from:
      * ``'winding'``: batch = (cloud[B, Np, 5], forcing, sink); chi is
        computed from the cloud on the batch's device;
      * ``'inputs'``: batch = (inputs[B, H, W, C], forcing); chi is
        ``inputs[..., 1]``.
    ibn_loss_type: ``'energy'`` (default), ``'resmin'`` (sum of squared
      Galerkin residuals) or ``'mask'`` (regress the raw winding field;
      winding batches only).
    neumann: zero diffusivity inside the object instead of Dirichlet
      ``bc1_value`` there; the Dirichlet sets are bc2 (value 1) and, with a
      fourth channel, bc3 (value 0).
    bc1_value: the Dirichlet value inside the object (1.0).
    vae_kl_weight: weight of the KL term when the network returns
      ``(out, mu, logvar)`` (1e-4).
    network_input: what the network takes on winding batches: ``'chi'``
      (the occupancy grid ``[B, H, W, 1]``), ``'cloud'`` (the points
      ``[B, Np, 2]``: ``DGCNN2D``, ``ImmDiff``) or ``'cloud_normals'``
      (points and normals, two arguments: ``ImmDiffLargeNormals``). chi
      still sets the immersed Dirichlet set.
    mesh: a process mesh whose 'space' axis splits the fields' rows (see
      the module's docstring; ``source_from='inputs'`` and the energy
      only).
    """

    def __init__(self, network=None, dataset=None, source_from="winding",
                 winding_threshold=0.5, neumann=False,
                 ibn_loss_type="energy", network_input="chi", mesh=None,
                 **kwargs):
        super().__init__(network, dataset, **kwargs)
        if network_input not in ("chi", "cloud", "cloud_normals"):
            raise ValueError(f"unknown network_input {network_input!r}")
        if ibn_loss_type not in ("energy", "resmin", "mask"):
            raise ValueError(f"unknown ibn_loss_type {ibn_loss_type!r}")
        if spatial_mesh(mesh) is not None and (
                source_from == "winding" or ibn_loss_type != "energy"):
            raise NotImplementedError(
                "IBNPoisson2D over a 'space' axis splits the energy of "
                "fields given as inputs (source_from='inputs', "
                f"ibn_loss_type='energy'), not source_from={source_from!r} "
                f"with ibn_loss_type={ibn_loss_type!r}")
        self.mesh = _checked_mesh(self, mesh)
        self.source_from = source_from
        self.winding_threshold = winding_threshold
        self.neumann = neumann
        self.bc1_value = float(kwargs.get("bc1_value", 1.0))
        self.ibn_loss_type = ibn_loss_type
        self.vae_kl_weight = float(kwargs.get("vae_kl_weight", 1e-4))
        self.network_input = network_input

    def _grid_args(self, cloud):
        return (cloud[..., 0:2], cloud[..., 2:4], cloud[..., 4],
                (self.domain_sizeY, self.domain_sizeX),
                (self.domain_lengthX, self.domain_lengthY))

    def _chi(self, cloud):
        """chi [B, H, W, 1] of a cloud batch."""
        return occupancy_from_cloud(*self._grid_args(cloud),
                                    threshold=self.winding_threshold)[..., None]

    def _apply_net(self, cloud, source):
        """The network's raw output (a VAE head's is (out, mu, logvar)) on
        `source`, or on the cloud for the point-cloud networks."""
        if self.network_input == "cloud":
            return self.network(cloud[..., 0:2])
        if self.network_input == "cloud_normals":
            return self.network(cloud[..., 0:2], cloud[..., 2:4])
        return self.network(source)

    def _from_cloud(self, cloud, sink):
        """The network's raw output and the inputs stack (ones, chi,
        sink)."""
        source = self._chi(cloud)
        inputs = torch.cat([torch.ones_like(source), source, sink], dim=-1)
        return self._apply_net(cloud, source), inputs

    def forward(self, batch):
        """``(u, inputs, forcing)``; a VAE head gives its out as u."""
        if self.source_from != "winding":
            inputs, forcing = batch
            return self.network(inputs), inputs, forcing
        cloud, forcing, sink = batch
        u, inputs = self._from_cloud(cloud, sink)
        if isinstance(u, tuple):
            u = u[0]
        return u, inputs, forcing

    def training_loss(self, batch) -> torch.Tensor:
        """The mean loss of `batch`, plus the weighted KL term when the
        network is a VAE head; with ``ibn_loss_type='mask'`` the squared
        error of the network's output against the raw winding field. With
        ``remat`` the whole of it runs under ``torch.utils.checkpoint``."""
        return self._remat(self._ibn_training_loss, batch)

    def _ibn_training_loss(self, batch) -> torch.Tensor:
        if self.source_from != "winding":
            u, inputs, forcing = self(batch)
            return torch.mean(self.loss(u, inputs, forcing))
        cloud, forcing, sink = batch
        if self.ibn_loss_type == "mask":
            w = winding_grid(*self._grid_args(cloud))
            u = self._apply_net(cloud, w[..., None])
            if isinstance(u, tuple):
                u = u[0]
            u = u[..., 0] if u.ndim == w.ndim + 1 else u
            return torch.mean((u - w) ** 2)
        u, inputs = self._from_cloud(cloud, sink)
        if isinstance(u, tuple):
            return self.loss_from_parts(self._vae_parts(u, inputs, forcing))
        return torch.mean(self.loss(u, inputs, forcing))

    def _vae_parts(self, u, inputs, forcing) -> list:
        """With a VAE head: the loss of the field (for resmin the sum of
        R^2 over the batch) and the sum and count of the KL terms, whose
        mean the loss takes."""
        u, mu, logvar = u
        kl_terms = torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar),
                             dim=-1)
        return [torch.sum(self.loss(u, inputs, forcing)), torch.sum(kl_terms),
                kl_terms.new_tensor(float(kl_terms.numel()))]

    def _training_parts(self, batch) -> torch.Tensor:
        cloud, forcing, sink = batch
        u, inputs = self._from_cloud(cloud, sink)
        return torch.stack(self._vae_parts(u, inputs, forcing))

    def loss_from_parts(self, parts) -> torch.Tensor:
        return parts[0] + self.vae_kl_weight * (-0.5 * parts[1] / parts[2])

    @property
    def batch_reduction(self) -> str | None:
        """resmin sums R^2 over the batch (``"global"`` with a VAE, whose KL
        term is a batch mean: the sums of both are reduced, then the mean
        taken); the energy and the mask regression take means."""
        from ..models.networks import VAE

        if self.ibn_loss_type != "resmin":
            return "mean"
        return "global" if isinstance(self.network, VAE) else "sum"

    def _nu_and_dirichlet(self, inputs_tensor):
        """The diffusivity and the constrained node set: with ``neumann``,
        nu = 0 inside the object and the outer sets bc2 (and bc3);
        otherwise the object (bc1) and bc2."""
        nu = inputs_tensor[..., 0]
        bc1 = inputs_tensor[..., 1]
        bc2 = inputs_tensor[..., 2]
        if not self.neumann:
            return nu, torch.maximum(bc1, bc2)
        nu = torch.where(bc1 > 0.5, torch.zeros_like(nu), nu)
        if inputs_tensor.shape[-1] > 3:
            return nu, torch.maximum(bc2, inputs_tensor[..., 3])
        return nu, bc2

    def apply_bcs(self, u, inputs_tensor):
        """The immersed Dirichlet substitution that :meth:`loss` applies;
        [B, H, W]."""
        if u.ndim == inputs_tensor.ndim:
            u = u[..., 0]
        if self.neumann:
            u = self.apply_dirichlet(u, inputs_tensor[..., 2], 1.0)
            if inputs_tensor.shape[-1] > 3:
                u = self.apply_dirichlet(u, inputs_tensor[..., 3], 0.0)
            return u
        u = self.apply_dirichlet(u, inputs_tensor[..., 1], self.bc1_value)
        return self.apply_dirichlet(u, inputs_tensor[..., 2], 0.0)

    def residual_for_field(self, u, inputs_tensor, forcing_tensor):
        """The assembled Galerkin residual of a nodal field, for the
        matrix-free Krylov solve (``train.linear.module_linear_solve``):
        Dirichlet data substituted, rows of the constrained set zeroed.
        Affine in u; its solution is the direct single-geometry solve the
        trained network is scored against. Inputs are (nu, bc1, bc2[,
        bc3]), the stack :meth:`forward` builds. Whole fields only."""
        if spatial_mesh(self.mesh) is not None:
            raise NotImplementedError("residual_for_field takes whole "
                                      "fields, not blocks split over "
                                      "'space'")
        nu, dirichlet = self._nu_and_dirichlet(inputs_tensor)
        f = _squeeze_field(forcing_tensor)
        u = self.apply_bcs(_squeeze_field(u), inputs_tensor)
        return poisson_resmin_residual(
            self, u, self.gauss_pt_evaluation(nu),
            self.gauss_pt_evaluation(f), dirichlet)

    def loss(self, u, inputs_tensor, forcing_tensor):
        if u.ndim == inputs_tensor.ndim:
            u = u[..., 0]
        f = forcing_tensor[..., 0] if forcing_tensor.ndim == u.ndim + 1 \
            else forcing_tensor
        nu, dirichlet = self._nu_and_dirichlet(inputs_tensor)
        u = self.apply_bcs(u, inputs_tensor)
        if self.ibn_loss_type == "resmin":
            R = poisson_resmin_residual(
                self, u, self.gauss_pt_evaluation(nu),
                self.gauss_pt_evaluation(f), dirichlet)
            return torch.sum(R**2)
        # the reference IBN weights its energy by the Gauss weights alone
        return _energy(self, u, nu, f)


def _checked_mesh(module, mesh):
    """`mesh`, once the module's network is known to take and give the
    same row blocks (built on the same mesh) where 'space' splits."""
    if spatial_mesh(mesh) is not None and \
            getattr(module.network, "mesh", None) is not mesh:
        raise ValueError(f"{type(module).__name__} over a 'space' axis needs "
                         "a network built on the same mesh (UNet(mesh=), "
                         "UNet3D(mesh=))")
    return mesh


def _energy(module, u, nu, f):
    """The Ritz energy weighted by the Gauss weights alone, the global one
    on every rank over the module's 'space' axis."""
    mesh = spatial_mesh(module.mesh)
    w = module.basis.gpw(u.dtype)
    if mesh is None:
        return poisson_energy_loss(module, u, nu, f, w)
    return poisson_energy_loss_split(module, u, nu, f, w, mesh)


class IBNPoisson3D(FEM3DModule):
    """3D parametric IBN on voxel topology ensembles. Batch = (inputs[B, D,
    H, W, C], forcing); the network takes the inputs (domain, chi, bc2);
    u = 1 on chi, 0 on bc2; the energy is weighted by the Gauss weights
    alone, as in 2D. mesh: a process mesh whose 'space' axis splits the
    fields' depth planes (see the module's docstring)."""

    def __init__(self, network=None, dataset=None, mesh=None, **kwargs):
        super().__init__(network, dataset, **kwargs)
        self.mesh = _checked_mesh(self, mesh)

    def apply_bcs(self, u, inputs_tensor):
        """The Dirichlet substitution :meth:`loss` applies; [B, D, H, W]."""
        if u.ndim == inputs_tensor.ndim:
            u = u[..., 0]
        u = self.apply_dirichlet(u, inputs_tensor[..., 1], 1.0)
        return self.apply_dirichlet(u, inputs_tensor[..., 2], 0.0)

    def loss(self, u, inputs_tensor, forcing_tensor):
        u = self.apply_bcs(u, inputs_tensor)
        f = forcing_tensor[..., 0] if forcing_tensor.ndim == u.ndim + 1 \
            else forcing_tensor
        return _energy(self, u, inputs_tensor[..., 0], f)
