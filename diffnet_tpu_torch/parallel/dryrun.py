"""The multi-device dry run (counterpart of ``dryrun_multichip`` in the
repository's ``__graft_entry__.py``): one step of each of four workloads
over a ``data x space`` process mesh.

``dryrun_multigpu(world)`` spawns `world` ranks and lays them out as the
JAX dry run lays out its devices: ``space = 2`` for an even world, ``data
= world / space``. Every rank draws the JAX dry run's inputs, in its order,
from ``numpy.random.default_rng(0)``. The workloads, at the JAX dry run's
sizes:

  (a) IBNPoisson2D with a UNet(base_filters=4) on 32^2, batch 2 x data, one
      Adam step through ``Trainer.fit`` over a loader on the mesh, the
      inputs' rows split over 'space' as the JAX dry run shards them
      (``P("data", "space", None, None)``: the network on halo'd row
      blocks, its instance norms all-reduced, the energy summed over the
      blocks; the gradient averaged over 'space', then 'data');
  (b) the VMS Navier-Stokes objective (the squared norms of the three
      residuals) on 16^2 lid-driven cavity fields split over ``('data',
      'space')`` as the JAX dry run shards them (one sample a data rank,
      its rows split over 'space': ``calc_residuals(mesh=)``, one halo row
      of the fields from each neighbour), one gradient step on each rank's
      block of the fields (through the exchange's backward), the objective
      summed over both axes;
  (c) CG on the 32^2 Poisson problem with the rows split over 'space', every
      matvec through the spatial K1 path
      (:func:`~.spatial.poisson_stiffness_spatial_fused`), the relative
      residual below 1e-2 as the JAX dry run asserts;
  (d) IBNPoisson3D with a UNet3D(base_filters=2) on 32^3, 8 samples a data
      rank (the reference's per-GPU batch), one Adam step through
      ``Trainer.fit``, the depth planes split over 'space' as (a)'s rows
      (``P("data", "space", None, None, None)``).

The backend follows the device: NCCL with one card a rank where there are
cards enough, gloo otherwise (CPU tensors, or several ranks sharing a card
with the halo rows and all-reduces through host memory).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..core import fem
from ..core.quadrature import make_basis
from ..utils.device import resolve_device
from .launch import rank_device, run_ranks
from .mesh import local_block, make_mesh
from .spatial import poisson_stiffness_spatial_fused

__all__ = ["dryrun_multigpu"]


class _Arrays:
    """Arrays as a dataset of ``(inputs[i], forcing[i])`` items (not
    ``InMemoryDataset``, whose gather needs the host library, built with
    g++ at first use)."""

    def __init__(self, inputs, forcing):
        self.inputs, self.forcing = inputs, forcing

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, i):
        return self.inputs[i], self.forcing[i]


def _one_adam_step(module, inputs, forcing, mesh, dev) -> float:
    """One Adam step on the global batch, its rows along 'data' and its
    axis 1 along 'space' split over `mesh`."""
    from ..data.loader import NumpyLoader
    from ..train.trainer import Trainer

    loader = NumpyLoader(_Arrays(inputs, forcing), batch_size=len(inputs),
                         device=dev, mesh=mesh, space_axis=1)
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=1e-3,
                 device=dev)
    tr.fit(module, loader)
    return tr.step_losses[0]


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """The four workloads on this rank of an initialised process group of
    `world` ranks (what :func:`dryrun_multigpu` runs in each); its figures
    as a dict."""
    from ..data.flow import NSLDCDataset
    from ..models.networks import UNet, UNet3D
    from ..pde.flow import NavierStokes
    from ..pde.ibn import IBNPoisson2D, IBNPoisson3D
    from ..train.linear import solve_linear

    dev = rank_device(dist.get_backend(), device)
    space = 2 if world % 2 == 0 and world >= 2 else 1
    data = world // space
    mesh = make_mesh(data=data, space=space)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)

    # (a) the IBN UNet step
    n, bs = 32, 2 * data
    net = UNet(3, 1, base_filters=4, mesh=mesh)
    module = IBNPoisson2D(net, source_from="inputs", domain_size=n,
                          batch_size=bs, mesh=mesh)
    inputs = rng.random((bs, n, n, 3)).astype(np.float32)
    forcing = rng.random((bs, n, n, 1)).astype(np.float32)
    loss = _one_adam_step(module, inputs, forcing, mesh, dev)

    # (b) the NS VMS objective step, one cavity sample a data rank, its
    # rows split over 'space'
    nn_ = 16
    ds = NSLDCDataset(domain_sizes=(nn_, nn_), Re=100)
    m2 = NavierStokes(None, ds, domain_size=nn_, batch_size=data,
                      Re=100).to(dev)
    fields = [local_block(local_block(
        rng.random((data, nn_, nn_)).astype(np.float32), mesh), mesh, 1,
        "space") * 0.1 for _ in range(3)]
    fields = [torch.tensor(f, device=dev, requires_grad=True)
              for f in fields]
    ns_in = torch.tensor(local_block(np.asarray(ds[0][0], np.float32)[None],
                                     mesh, 1, "space"), device=dev)
    R1, R2, R3 = m2.calc_residuals(tuple(fields), ns_in, None, mesh)
    obj = (R1**2).sum() + (R2**2).sum() + (R3**2).sum()   # this block's
    obj.backward()
    with torch.no_grad():
        for f in fields:
            f -= 1e-3 * f.grad
    ns_loss = float(mesh.all_reduce(mesh.all_reduce(obj.detach(), "space"),
                                    "data"))

    # (c) CG with the rows split over 'space', matvecs through spatial K1
    nk = 32
    tb = fem.BasisTables(make_basis(2, 1, h=(1.0 / (nk - 1),) * 2)).to(dev)
    bck = np.zeros((nk, nk), np.float32)
    bck[[0, -1]] = 1.0
    bk = np.where(bck > 0.5, 0.0, rng.standard_normal((nk, nk))
                  ).astype(np.float32)
    bck_l, bk_l = (torch.tensor(local_block(a, mesh, 0, "space"),
                                device=dev) for a in (bck, bk))
    ones = torch.ones((1,) + tuple(bk_l.shape), device=dev)

    def resfn(u):
        K = poisson_stiffness_spatial_fused(u[None].contiguous(), ones, tb,
                                            mesh)[0]
        return torch.where(bck_l > 0.5, torch.zeros_like(K), K) - bk_l

    u_sol, _ = solve_linear(resfn, tuple(bk_l.shape), tol=1e-6, maxiter=50,
                            x0=torch.zeros_like(bk_l), device=dev, mesh=mesh)
    with torch.no_grad():
        r2 = mesh.all_reduce((resfn(u_sol) ** 2).sum(), "space")
        b2 = mesh.all_reduce((bk_l**2).sum(), "space")
    rel = float((r2 / b2).sqrt())
    if not rel < 1e-2:
        raise RuntimeError(f"sharded CG did not converge: rel res {rel}")

    # (d) the 3D IBN step, 8 samples a data rank
    n3, bs3 = 32, 8 * data
    net3 = UNet3D(3, 1, base_filters=2, mesh=mesh)
    m3 = IBNPoisson3D(net3, domain_size=n3, batch_size=bs3, mesh=mesh)
    in3 = rng.random((bs3, n3, n3, n3, 3)).astype(np.float32)
    f3 = rng.random((bs3, n3, n3, n3, 1)).astype(np.float32)
    l3 = _one_adam_step(m3, in3, f3, mesh, dev)

    for name, v in (("loss", loss), ("ns_loss", ns_loss), ("ibn3d", l3)):
        if not math.isfinite(v):
            raise RuntimeError(f"non-finite {name} {v}")
    return {"backend": mesh.backend, "world": world, "data": data,
            "space": space, "device": str(dev), "loss": loss,
            "ns_loss": ns_loss, "ns_block": list(R1.shape),
            "cg_rel_res": rel, "ibn3d_loss": l3,
            "ibn3d_batch": bs3}


def dryrun_multigpu(world: int, backend: str | None = None,
                    device: str | torch.device = "cuda",
                    timeout: float = 600.0, threads: int | None = None
                    ) -> dict:
    """Run the four workloads over `world` spawned ranks and return rank
    0's figures (``loss``, ``ns_loss``, ``cg_rel_res``, ``ibn3d_loss`` and
    the mesh); raises if any rank fails. backend: ``"nccl"`` or
    ``"gloo"``; by default NCCL on CUDA when there are `world` cards, else
    gloo. device: ``"cuda"`` (the default; raises without CUDA) or
    ``"cpu"``. threads: ``torch.set_num_threads`` in each rank."""
    device = resolve_device(device, "dryrun_multigpu")
    if backend is None:
        backend = ("nccl" if device.type == "cuda"
                   and torch.cuda.device_count() >= world else "gloo")
    out = run_ranks(_dryrun_rank, world, (str(device),), backend=backend,
                    timeout=timeout, threads=threads)
    r = out[0]
    print(f"dryrun_multigpu({world}): backend={r['backend']} mesh=(data="
          f"{r['data']}, space={r['space']}) loss={r['loss']:.6f} "
          f"ns_loss={r['ns_loss']:.6f} cg_rel_res={r['cg_rel_res']:.2e} "
          f"ibn3d_loss={r['ibn3d_loss']:.6f} (bs={r['ibn3d_batch']} @ "
          "32^3; (a), (b), (d) split over data and space) OK", flush=True)
    return r
