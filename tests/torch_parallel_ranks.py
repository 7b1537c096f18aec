"""Rank bodies for the multi-process tests of the port's parallel package
(tests/test_torch_parallel.py, test_torch_spatial.py,
test_torch_spatial3d.py).

Spawned ranks re-import the module that defines their function, and the
test modules import JAX, so the bodies live here: this module imports
torch, numpy and the port only. Each body takes its inputs as numpy arrays
from the test, runs on the CPU over a gloo group, and returns numpy arrays
(rank r's blocks; the tests put them together).
"""

from __future__ import annotations

import numpy as np
import torch

from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.data import NumpyLoader
from diffnet_tpu_torch.models import DirectField, UNet
from diffnet_tpu_torch.parallel import (gather_block, halo_exchange_y,
                                        halo_exchange_z, local_block,
                                        make_mesh,
                                        poisson_residual_spatial,
                                        poisson_stiffness_spatial_fused,
                                        poisson_stiffness_spatial_fused_3d,
                                        shard_batch)
from diffnet_tpu_torch.pde import IBNPoisson2D, Poisson2D
from diffnet_tpu_torch.train import Trainer, solve_linear


class Arrays:
    """``(inputs[i], forcing[i])`` items of two arrays (no ``batch``
    method: the loader's per-item path)."""

    def __init__(self, inputs, forcing):
        self.inputs, self.forcing = inputs, forcing

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, i):
        return self.inputs[i], self.forcing[i]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def _halo(x, w, mesh, exchange):
    """The halo'd block of `x` (this rank's block) and the gradient of
    ``<w, halo'd block>`` (w this rank's weights on it)."""
    xl = _t(x, grad=True)
    h = exchange(xl, mesh)
    (h * _t(w)).sum().backward()
    return h.detach().numpy(), xl.grad.numpy()


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py


def ibn_module(net, n, bs):
    return IBNPoisson2D(net, source_from="inputs", domain_size=n,
                        batch_size=bs)


def resmin_module(n, bs, init):
    return Poisson2D(DirectField((n, n), init=init), None, domain_size=n,
                     batch_size=bs, loss_type="resmin")


def fit_once(module, inputs, forcing, mesh=None, **trainer_kw):
    """One epoch of one global batch through ``Trainer.fit``: the state
    dict after it (numpy) and its step loss."""
    loader = NumpyLoader(Arrays(inputs, forcing), batch_size=len(inputs),
                         mesh=mesh)
    tr = Trainer(max_epochs=1, device="cpu", **trainer_kw)
    st = tr.fit(module, loader)
    return ({k: v.numpy().copy() for k, v in st.params.items()},
            tr.step_losses[0])


def grads_of(module) -> dict:
    """The gradients a fit's last step left on the module's network: after
    a one-step fit, that step's (over a mesh, all-reduced)."""
    return {k: v.grad.numpy().copy()
            for k, v in module.network.named_parameters()}


def parallel_rank(rank: int, world: int, p: dict) -> dict:
    out = {}
    mesh = make_mesh(data=1, space=world)
    # the halo exchange along y (JAX's case: a 32 x 4 ramp) and along z
    out["halo_y"] = _halo(local_block(p["ramp_y"], mesh, 0, "space"),
                          p["w_y"][rank], mesh, halo_exchange_y)
    out["halo_z"] = _halo(local_block(p["ramp_z"], mesh, 1, "space"),
                          p["w_z"][rank], mesh, halo_exchange_z)
    out["gather"] = gather_block(
        _t(local_block(p["ramp_z"], mesh, 1, "space")), mesh, 1).numpy()

    dmesh = make_mesh(data=world)
    out["shard_batch"] = shard_batch(p["batch"], dmesh)
    out["shard_batch_bs"] = shard_batch(p["batch"], dmesh,
                                        batch_size=p["batch"][3].shape[0])
    loader = NumpyLoader(Arrays(p["ids"], p["ids"]), batch_size=8,
                         shuffle=True, seed=3, mesh=dmesh)
    out["loader"] = [[b[0].numpy() for b in loader] for _ in range(2)]
    out["loader_len"] = len(loader)

    # one data-parallel Adam step of IBNPoisson2D with a small UNet
    n, bs = p["ibn_inputs"].shape[1], p["ibn_inputs"].shape[0]
    net = UNet(3, 1, base_filters=4)
    # every rank but the first starts elsewhere: fit replicates rank 0's
    net.load_state_dict(p["unet_state"] if rank == 0 else
                        {k: torch.randn_like(v)
                         for k, v in net.state_dict().items()})
    m = ibn_module(net, n, bs)
    out["adam"] = fit_once(m, p["ibn_inputs"], p["ibn_forcing"], dmesh,
                           optimizer="adam", learning_rate=1e-3)
    out["adam_grad"] = grads_of(m)
    # a DirectField resmin fit (a loss summed over the batch): one SGD step
    # at lr 1 (the global gradient) and one 10-iteration LBFGS epoch
    n, bs = p["res_inputs"].shape[1], p["res_inputs"].shape[0]
    for name, kw in (("sgd", {"optimizer": "sgd", "learning_rate": 1.0}),
                     ("lbfgs", {"optimizer": "lbfgs",
                                "lbfgs_max_iter": 10})):
        out[name] = fit_once(resmin_module(n, bs, p["field0"]),
                             p["res_inputs"], p["res_forcing"], dmesh, **kw)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_spatial.py and tests/test_torch_spatial3d.py


def _spatial_case(fn, u, nu, g, basis, mesh, axis):
    """This rank's block of ``fn(u, nu)`` and the gradients of ``<g, fn(u,
    nu)>`` in u and nu, from the global arrays."""
    ul = _t(local_block(u, mesh, axis, "space"), grad=True)
    nul = _t(local_block(nu, mesh, axis, "space"), grad=True)
    R = fn(ul, nul, basis, mesh)
    (R * _t(local_block(g, mesh, axis, "space"))).sum().backward()
    return R.detach().numpy(), ul.grad.numpy(), nul.grad.numpy()


# CG to JAX's test tolerance; BiCGSTAB for a fixed 8 iterations (tol 0):
# on this SPD problem its float32 iterates part by rounding within a few
# tens of iterations (the unsplit and split solves are 5e-4 apart at 30)
SOLVES = {"cg": {"tol": 1e-8, "maxiter": 200},
          "bicgstab": {"tol": 0.0, "maxiter": 8}}


def spatial_rank(rank: int, world: int, p: dict) -> dict:
    out = {}
    mesh = make_mesh(data=1, space=world)
    for key, (u, nu, g) in p["cases"].items():
        n = u.shape[-1]
        basis = fem.BasisTables(make_basis(2, 1, h=(1 / (n - 1),) * 2))
        for name, fn in (("plain", poisson_residual_spatial),
                         ("k1", poisson_stiffness_spatial_fused)):
            out[name, key] = _spatial_case(fn, u, nu, g, basis, mesh, 1)
    # CG over the row-split field, every matvec through spatial K1
    b, bc = p["cg_b"], p["cg_bc"]
    n = b.shape[-1]
    basis = fem.BasisTables(make_basis(2, 1, h=(1 / (n - 1),) * 2))
    bl, bcl = (_t(local_block(a, mesh, 0, "space")) for a in (b, bc))
    ones = torch.ones((1,) + tuple(bl.shape))

    def resfn(u):
        K = poisson_stiffness_spatial_fused(u[None].contiguous(), ones,
                                            basis, mesh)[0]
        return torch.where(bcl > 0.5, torch.zeros_like(K), K) - bl

    for method, kw in SOLVES.items():
        u, _ = solve_linear(resfn, tuple(bl.shape), method=method,
                            x0=torch.zeros_like(bl), device="cpu", mesh=mesh,
                            **kw)
        out["solve", method] = u.numpy()
    return out


def spatial3d_rank(rank: int, world: int, p: dict) -> dict:
    out = {}
    mesh = make_mesh(data=1, space=world)
    for key, (u, nu, g) in p["cases"].items():
        h = tuple(1 / (s - 1) for s in u.shape[:0:-1])
        basis = fem.BasisTables(make_basis(3, 1, h=h))
        out[key] = _spatial_case(poisson_stiffness_spatial_fused_3d, u, nu,
                                 g, basis, mesh, 1)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_cuda.py (on the card; the ranks share it over gloo)


def spatial_cuda_rank(rank: int, world: int, shapes: list) -> dict:
    """For each shape, this rank's block of the spatial K1 (2D) or K5 (3D)
    action and of its u and nu VJPs against the unsharded kernel's rows
    on the card: ``(max |diff|, max |ref|)`` of each, and the kernels'
    launches in the spatial calls."""
    from diffnet_tpu_torch.ops import poisson_residual as k1
    from diffnet_tpu_torch.ops import poisson_residual_3d as k5
    from diffnet_tpu_torch.ops.poisson_residual import (
        poisson_stiffness_action)
    from diffnet_tpu_torch.ops.poisson_residual_3d import (
        poisson_stiffness_action_3d)

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = make_mesh(data=1, space=world)
    out = {}
    for shape in shapes:
        nsd = len(shape) - 1
        gen = torch.Generator().manual_seed(5)
        u, nu, g = (torch.rand(shape, generator=gen).to(dev) + c
                    for c in (0.0, 0.5, -0.5))
        basis = fem.BasisTables(make_basis(
            nsd, 1, h=tuple(1 / (s - 1) for s in shape[:0:-1]))).to(dev)
        spatial = (poisson_stiffness_spatial_fused if nsd == 2
                   else poisson_stiffness_spatial_fused_3d)
        op = (poisson_stiffness_action if nsd == 2
              else poisson_stiffness_action_3d)
        ul, nul = (local_block(t, mesh, 1, "space").contiguous()
                   .requires_grad_(True) for t in (u, nu))
        k1.launches = k5.launches = 0
        R = spatial(ul, nul, basis, mesh)
        (R * local_block(g, mesh, 1, "space")).sum().backward()
        torch.cuda.synchronize()
        launches = (k1.launches, k5.launches)
        u.requires_grad_(True)
        nu.requires_grad_(True)
        Rf = op(u, nu, basis)
        (Rf * g).sum().backward()
        out[tuple(shape)] = {
            "launches": launches,
            "errs": [(float((a - local_block(b, mesh, 1, "space")
                             ).abs().max()), float(b.abs().max()))
                     for a, b in ((R.detach(), Rf.detach()),
                                  (ul.grad, u.grad), (nul.grad, nu.grad))]}
    return out
