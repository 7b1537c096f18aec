"""Multi-GPU scaling demo: data-parallel and spatially sharded Poisson
training over a process mesh (counterpart of
``examples/multichip_scaling.py``).

The batch is split over the mesh's 'data' axis (the gradient all-reduced
over it, as DDP does) and the grid rows over its 'space' axis: each rank
holds its rows of the field being trained and of the batch's
diffusivities, and every residual runs through the spatial K1 path
(:func:`~.spatial.poisson_stiffness_spatial_fused`: one halo row from each
neighbour, K1 on the halo'd block). One process a rank, launched by
torchrun:

    torchrun --nproc-per-node 4 -m diffnet_tpu_torch.parallel.scaling \\
        --data 2 --space 2

NCCL when there is a card a rank, gloo otherwise (``--backend`` chooses;
``--device cpu`` runs on the CPU). The first rank prints the loss, the
time of a step and the element evaluations a second across the ranks.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import fem
from ..core.quadrature import make_basis
from ..utils.device import resolve_device
from .launch import rank_device
from .mesh import local_block, make_mesh
from .spatial import poisson_stiffness_spatial_fused


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=int, default=None,
                   help="ranks along 'data' (default: world / space)")
    p.add_argument("--space", type=int, default=1)
    p.add_argument("--domain-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl with a card a rank)")
    args = p.parse_args(argv)

    device = resolve_device(args.device, "parallel.scaling")
    if not dist.is_initialized():
        # torchrun's environment: WORLD_SIZE, RANK, LOCAL_RANK, MASTER_*
        world = int(os.environ.get("WORLD_SIZE", "1"))
        backend = args.backend or (
            "nccl" if device.type == "cuda"
            and torch.cuda.device_count() >= world else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
    try:
        return _train(args, device)
    finally:
        dist.destroy_process_group()


def _train(args, device) -> dict:
    mesh = make_mesh(data=args.data, space=args.space)
    dev = rank_device(mesh.backend, device)
    n, bs = args.domain_size, args.batch_size
    h = 1.0 / (n - 1)
    basis = fem.BasisTables(make_basis(2, 1, h=(h, h)))
    rng = np.random.default_rng(0)
    nu = rng.random((bs, n, n)).astype(np.float32)
    f_gp = rng.random((bs, n - 1, n - 1, 4)).astype(np.float32)
    bc = np.zeros((n, n), np.float32)
    bc[[0, -1], :] = 1.0
    bc[:, [0, -1]] = 1.0
    Nf = fem.galerkin_project(torch.from_numpy(f_gp), basis, "N",
                              (n, n)).numpy()

    def mine(a, batched=True):
        """This rank's rows of the batch and of the grid."""
        if batched:
            a = local_block(a, mesh, 0, "data")
        return torch.tensor(local_block(a, mesh, a.ndim - 2, "space"),
                            device=dev)

    nu_l, Nf_l, bc_l = mine(nu), mine(Nf), mine(bc, batched=False)
    basis = basis.to(dev)
    # this rank's rows of the field, the same on every rank along 'data'
    u = torch.nn.Parameter(torch.zeros(tuple(bc_l.shape), device=dev))
    opt = torch.optim.Adam([u], lr=1e-2)

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        ub = torch.where(bc_l > 0.5, 0.0, u)[None].expand(
            nu_l.shape).contiguous()
        R = poisson_stiffness_spatial_fused(ub, nu_l, basis, mesh) - Nf_l
        loss = (torch.where(bc_l > 0.5, 0.0, R) ** 2).sum()
        loss.backward()
        u.grad = mesh.all_reduce(u.grad, "data")
        opt.step()
        return loss.detach()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    sync()
    dt = (time.perf_counter() - t0) / args.steps
    # the global loss: this rank's rows summed over both axes
    loss = float(mesh.all_reduce(mesh.all_reduce(loss, "data"), "space"))
    ranks = mesh.data * mesh.space
    rate = bs * (n - 1) ** 2 / dt / 1e6
    if mesh.lead:
        print(f"loss: {loss:.4e}  step: {dt * 1e3:.2f} ms ({rate:.1f} M "
              f"elem-evals/s across {ranks} ranks; backend "
              f"{mesh.backend}, {dev.type})", flush=True)
    return {"loss": loss, "step_ms": dt * 1e3, "elem_evals_per_s": rate * 1e6,
            "ranks": ranks, "backend": mesh.backend}


if __name__ == "__main__":
    main()
