"""Rank bodies for the multi-process tests of the port's U-Nets and IBN
energies split over 'space' (tests/test_torch_spatial_nets.py).

Spawned ranks re-import the module that defines their function, and the
test module imports JAX, so the body lives here: this module imports
torch, numpy and the port only. It takes its inputs as numpy arrays, runs
on the CPU over a gloo group of 4 ranks, and returns numpy arrays (rank
r's blocks and shares; the test puts them together).

Meshes, made on every rank in one order: ``1 x 2`` (ranks 0, 1 and ranks
2, 3, two meshes of one shape running side by side), ``1 x 4``, ``2 x 2``
and ``4 x 1`` (no split).
"""

from __future__ import annotations

import numpy as np
import torch

from diffnet_tpu_torch.data import NumpyLoader
from diffnet_tpu_torch.interop import params_from_jax
from diffnet_tpu_torch.models import UNet, UNet3D
from diffnet_tpu_torch.models import networks as nets
from diffnet_tpu_torch.parallel import gather_block, local_block, make_mesh
from diffnet_tpu_torch.pde import IBNPoisson2D, IBNPoisson3D
from diffnet_tpu_torch.train import Trainer

MESHES = ("1x2", "1x4", "2x2")


class Arrays:
    """``(inputs[i], forcing[i])`` items of two arrays."""

    def __init__(self, inputs, forcing):
        self.inputs, self.forcing = inputs, forcing

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, i):
        return self.inputs[i], self.forcing[i]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def _meshes(world):
    """The test's meshes by name; every rank makes every group in one
    order."""
    pair = [make_mesh(data=1, space=2, group=g) for g in ([0, 1], [2, 3])]
    out = {"1x2": pair[0] or pair[1],
           "1x4": make_mesh(data=1, space=world),
           "2x2": make_mesh(data=2, space=2),
           "4x1": make_mesh(data=world, space=1)}
    return out


def _block(a, mesh, axis):
    """This rank's block of a global batch: its rows along 'data' (axis
    0), then along 'space' on `axis`."""
    return local_block(local_block(np.asarray(a), mesh, 0, "data"), mesh,
                       axis, "space")


def net_for(kind, mesh=None, dtype=torch.float64):
    """The test's networks, seeded: UNet(4) (2D) or UNet3D(2) (3D), three
    input channels."""
    cls, f = (UNet, 4) if kind == "2d" else (UNet3D, 2)
    return cls(3, 1, base_filters=f, seed=5, mesh=mesh).to(dtype)


def module_for(kind, net, n, bs, mesh=None):
    if kind == "2d":
        return IBNPoisson2D(net, source_from="inputs", domain_size=n,
                            batch_size=bs, mesh=mesh)
    return IBNPoisson3D(net, domain_size=n, batch_size=bs, mesh=mesh)


def reduced_grads(module, mesh) -> dict:
    """The module's network's gradients averaged over 'space', then over
    'data' (the Trainer's reduction for the energy)."""
    out = {}
    for k, p in module.network.named_parameters():
        g = mesh.all_reduce(p.grad, "space", "mean")
        out[k] = mesh.all_reduce(g, "data", "mean").numpy()
    return out


def _gradchecks(mesh, x) -> dict:
    """gradcheck of gather then scatter (identity on a rank's block) and of
    scatter then gather on the rank's own rows (identity there), along
    axis 1 of `x`."""
    n = x.shape[1]
    xb = _t(local_block(x, mesh, 1, "space"), grad=True)
    xf = _t(x, grad=True)
    own = torch.zeros_like(xf)
    local_block(own, mesh, 1, "space").fill_(1.0)
    return {
        "gather_scatter": torch.autograd.gradcheck(
            lambda b: local_block(gather_block(b, mesh, 1, "space", n), mesh,
                                  1, "space"), (xb,)),
        "scatter_gather": torch.autograd.gradcheck(
            lambda f: own * gather_block(local_block(f, mesh, 1, "space"),
                                         mesh, 1, "space", n), (xf,))}


def op_for(name, ndim, cin):
    """A seeded stage of the U-Net (its weights the same on every rank)."""
    g = torch.Generator().manual_seed(3)
    if name == "down":
        return nets.Down(cin, 3, g, ndim=ndim).double()
    if name == "up":
        return nets.Up(cin, 3, g, ndim=ndim).double()
    if name == "head":
        return nets._conv(cin, 2, 4, g, ndim=ndim).double()
    return None


def run_op(name, ndim, x, mesh=None):
    """One stage on channels-first x (this rank's rows with `mesh`): Down,
    Up (before the skip), the resize and head conv, or the norm."""
    op = op_for(name, ndim, x.shape[1])
    if name == "down":
        return op(x, mesh=mesh), op
    if name == "up":
        return op.upsample(x, mesh=mesh), op
    if name == "head":
        if mesh is None:
            out = torch.nn.functional.interpolate(x, scale_factor=2,
                                                  mode="nearest")
            return op(torch.nn.functional.pad(out, (2, 1) * ndim)), op
        return nets._head_split(x, op, ndim, mesh), op
    return nets._norm(x, mesh), None


def _ops(mesh, cases) -> dict:
    """Each stage's block of the output, and its VJP of this rank's block
    of the cotangent: the input block's and the weights' (this rank's
    share)."""
    out = {}
    for key, (x, g) in cases.items():
        name, ndim = key
        xb = _t(local_block(x, mesh, 2, "space"), grad=True)
        y, op = run_op(name, ndim, xb, mesh)
        (y * _t(local_block(g, mesh, 2, "space"))).sum().backward()
        out[key] = {"y": y.detach().numpy(), "dx": xb.grad.numpy(),
                    "dw": None if op is None else next(
                        op.parameters()).grad.numpy()}
    return out


def _nets(mesh, p) -> dict:
    """Each network's output block, the loss, and the gradients reduced as
    the Trainer reduces them, from this rank's block of the global batch."""
    out = {}
    for kind, (inputs, forcing) in p["nets"].items():
        n, bs = inputs.shape[1], inputs.shape[0]
        net = net_for(kind, mesh)
        m = module_for(kind, net, n, bs, mesh)
        xin, xf = _t(_block(inputs, mesh, 1)), _t(_block(forcing, mesh, 1))
        loss = m.training_loss((xin, xf))
        loss.backward()
        with torch.no_grad():
            y = net(xin)
        out[kind] = {"y": y.numpy(), "loss": float(
            mesh.all_reduce(loss.detach(), "data", "mean")),
            "grads": reduced_grads(m, mesh)}
    return out


def _energies(mesh, cases) -> dict:
    """The split IBN energies of seeded fields (no network) and their
    gradients in u on this rank's block."""
    out = {}
    for key, (u, inputs, forcing) in cases.items():
        kind, n = key
        m = module_for(kind, net_for(kind, mesh), n, u.shape[0], mesh)
        ub = _t(local_block(u, mesh, 1, "space"), grad=True)
        e = m.loss(ub, _t(local_block(inputs, mesh, 1, "space")),
                   _t(local_block(forcing, mesh, 1, "space")))
        e.backward()
        out[key] = {"energy": float(e.detach()), "du": ub.grad.numpy()}
    return out


def fit_step(kind, inputs, forcing, mesh=None, state=None, dtype=None):
    """One Adam step (lr 1e-3) of the IBN module on the global batch
    through ``Trainer.fit``, its fields split over `mesh`'s 'space' axis
    (a loader with ``space_axis=1``): the step's loss, the gradients it
    left, and the parameters after it (numpy)."""
    dtype = dtype or torch.float64
    net = net_for(kind, mesh, dtype)
    if state is not None:
        net.load_state_dict({k: torch.as_tensor(v) for k, v in
                             state.items()})
    m = module_for(kind, net, inputs.shape[1], len(inputs), mesh)
    loader = NumpyLoader(Arrays(inputs, forcing), batch_size=len(inputs),
                         mesh=mesh, space_axis=None if mesh is None else 1)
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=1e-3,
                 device="cpu")
    st = tr.fit(m, loader)
    return {"loss": tr.step_losses[0],
            "grads": {k: v.grad.numpy().copy()
                      for k, v in m.network.named_parameters()},
            "params": {k: v.numpy().copy() for k, v in st.params.items()}}


def nets_rank(rank: int, world: int, p: dict) -> dict:
    meshes = _meshes(world)
    out = {"gradcheck": {}, "ops": {}, "nets": {}, "energies": {}}
    for name in MESHES:
        mesh = meshes[name]
        if name != "2x2":
            out["gradcheck"][name] = _gradchecks(mesh, p["gradcheck"])
            out["ops"][name] = _ops(mesh, p["ops"])
            out["energies"][name] = _energies(mesh, p["energies"])
        out["nets"][name] = _nets(mesh, p)
    # a mesh of one 'space' rank runs the code it runs without one
    m41 = meshes["4x1"]
    x = _t(p["nets"]["2d"][0])
    with torch.no_grad():
        out["no_split"] = bool(torch.equal(net_for("2d", m41)(x),
                                           net_for("2d")(x)))
    inputs, forcing = p["nets"]["2d"]
    out["fit"] = {name: fit_step("2d", inputs, forcing, meshes[name])
                  for name in ("1x4", "2x2")}
    # the dry run's workload (a), split as it splits it, from JAX's tree
    a = p["dryrun_a"]
    out["dryrun_a"] = fit_step("2d", a["inputs"], a["forcing"],
                               meshes["2x2"], state=a["state"],
                               dtype=torch.float32)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_cuda.py: chip_smoke's slice Q1 at a small size


def q1_fit(p: dict, device: str, mesh=None) -> dict:
    """Adam steps (lr 3e-4) of IBNPoisson2D with UNet(base_filters=16) from
    ``p["state"]`` over ``p["inputs"]``'s batches of ``p["batch"]``, on
    `device`, the rows split over `mesh`'s 'space' axis: the step losses
    and the parameters after the first step (numpy)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    inputs, forcing = p["inputs"], p["forcing"]
    net = UNet(3, 1, base_filters=16, mesh=mesh)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in
                         p["state"].items()})
    m = IBNPoisson2D(net, source_from="inputs", domain_size=inputs.shape[1],
                     batch_size=p["batch"], mesh=mesh)
    loader = NumpyLoader(Arrays(inputs, forcing), batch_size=p["batch"],
                         device=device, mesh=mesh,
                         space_axis=None if mesh is None else 1)
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=3e-4,
                 device=device)
    after = {}

    def keep(opt, args, kwargs):
        if not after:
            after.update({k: v.detach().cpu().numpy().copy()
                          for k, v in net.state_dict().items()})

    handle = register_optimizer_step_post_hook(keep)
    try:
        tr.fit(m, loader)
    finally:
        handle.remove()
    return {"losses": tr.step_losses, "params": after}


def q1_cuda_rank(rank: int, world: int, p: dict) -> dict:
    """:func:`q1_fit` on the card over a 1 x `world` mesh (the ranks
    sharing it over gloo), TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return q1_fit(p, "cuda", make_mesh(data=1, space=world))
