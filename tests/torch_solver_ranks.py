"""Rank bodies for the multi-process tests of the port's split solvers, the
split Navier-Stokes residual and the data-parallel root-norm losses
(tests/test_torch_spatial_solvers.py, test_torch_spatial_flow.py,
test_torch_parallel_global.py).

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
from diffnet_tpu_torch.data import NSLDCDataset, RectangleManufactured
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.parallel import (gather_block, local_block,
                                        make_mesh,
                                        poisson_residual_spatial)
from diffnet_tpu_torch.pde import NavierStokes, Poisson2D
from diffnet_tpu_torch.train import (extract_stencil,
                                     multigrid_preconditioner, solve_linear)
from diffnet_tpu_torch.train.stencil import SplitStencil, assemble_stencil


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _rows(a, mesh, axis=0):
    """This rank's row block of a global array, as a contiguous tensor."""
    return _t(local_block(np.asarray(a), mesh, axis, "space")).contiguous()


# ---------------------------------------------------------------------------
# tests/test_torch_spatial_solvers.py


def poisson_varnu(n, nu, bc, b, basis, mesh=None):
    """``u -> K(nu) u`` masked on the walls, less b: the JAX test's residual
    (tests/test_parallel.py:247-253), of whole fields or of row blocks."""
    def resfn(u):
        if mesh is None:
            gp = fem.gp_eval(u[None], basis, ("dx", "dy"))
            nug = fem.gp_eval(nu[None], basis, ("N",))["N"]
            R = fem.galerkin_project_multi(
                [(nug * gp["dx"], "dx"), (nug * gp["dy"], "dy")], basis,
                tuple(u.shape))[0]
        else:
            R = poisson_residual_spatial(u[None], nu[None], basis, mesh)[0]
        return torch.where(bc > 0.5, torch.zeros_like(R), R) - b
    return resfn


def mms_factory(m_n):
    """The JAX test's multigrid levels (tests/test_parallel.py:297-301)."""
    ds = RectangleManufactured(domain_size=m_n)
    ds.n_samples = 1
    return Poisson2D(DirectField((m_n, m_n)), ds, domain_size=m_n,
                     batch_size=1, loss_type="resmin")


def mms_problem(n, b):
    """The JAX test's 65^2 MG-CG system (tests/test_parallel.py:314-322):
    the fine module's operator ``u -> R(u) - R(0)``, its stencil planes and
    the right-hand side ``b - R(0)``."""
    m = mms_factory(n)
    inputs = _t(m.dataset[0][0])[None]
    forcing = torch.zeros((1, n, n, 1))

    def R(u):
        return m.residual_for_field(u[None], inputs, forcing)[0]

    R0 = R(torch.zeros(n, n))
    C = extract_stencil(lambda u: R(u) - R0, (n, n), device="cpu")
    return C, _t(b) - R0


# the split GMRES runs, each against one process on the same problem: the
# Poisson residual for two restart cycles of 10 steps (tol 0: every step
# runs), the Navier-Stokes Jacobian action for one
GMRES = {"poisson": {"tol": 0.0, "restart": 10, "maxiter": 2},
         "ns": {"tol": 0.0, "restart": 10, "maxiter": 1}}


def solvers_rank(rank: int, world: int, p: dict) -> dict:
    out = {}
    mesh = make_mesh(data=1, space=world)

    # uneven blocks: local_block and gather_block round trips
    for n in p["round_trip"]:
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        blk = local_block(_t(x), mesh, 0, "space")
        out["round_trip", n] = (blk.numpy().copy(),
                                gather_block(blk, mesh, 0, n=n).numpy(),
                                gather_block(blk, mesh, 0).numpy())

    # the stencil matvec and CG over it (tests/test_parallel.py:229-278)
    s = p["stencil"]
    n = s["b"].shape[0]
    basis = fem.BasisTables(make_basis(2, 1, h=(1 / (n - 1),) * 2))
    resfn = poisson_varnu(n, *(_rows(s[k], mesh) for k in ("nu", "bc", "b")),
                          basis, mesh)
    shape = tuple(_rows(s["b"], mesh).shape)
    mv, rhs, C = assemble_stencil(resfn, shape, device="cpu", mesh=mesh)
    out["stencil_C"] = C.numpy()
    out["stencil_mv"] = mv(_rows(s["probe"], mesh)).numpy()
    out["stencil_cg"] = solve_linear(
        lambda u: mv(u) - rhs, shape, tol=1e-8, maxiter=200,
        x0=torch.zeros(shape), device="cpu", mesh=mesh)[0].numpy()
    # the same solve through solve_linear's own assembly, through K4's
    # entry (its plain version on the CPU)
    out["stencil_solve"] = solve_linear(
        resfn, shape, tol=1e-8, maxiter=200, x0=torch.zeros(shape),
        assemble="stencil", stencil_kernel="cuda", device="cpu",
        mesh=mesh)[0].numpy()
    out["gmres_poisson"] = solve_linear(
        resfn, shape, method="gmres", x0=torch.zeros(shape), device="cpu",
        mesh=mesh, **GMRES["poisson"])[0].numpy()

    # the V-cycle and 8 MG-CG iterations (tests/test_parallel.py:280-337)
    g = p["mg"]
    n = g["v"].shape[0]
    M, info = multigrid_preconditioner(mms_factory, n, device="cpu",
                                       mesh=mesh)
    out["mg_split_levels"] = info["split_levels"]
    out["mg_Mv"] = M(_rows(g["v"], mesh)).numpy()
    C, rhs = mms_problem(n, g["b"])
    A = SplitStencil(local_block(C, mesh, 1, "space"), mesh)
    rhs = local_block(rhs, mesh, 0, "space")
    out["mg_cg"] = solve_linear(
        lambda u: A(u) - rhs, tuple(rhs.shape), tol=1e-12, maxiter=8, M=M,
        x0=torch.zeros(rhs.shape), device="cpu", mesh=mesh)[0].numpy()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_spatial_flow.py


def ns_module(n, fused, gauge="mean-control"):
    ds = NSLDCDataset(domain_sizes=(n, n), Re=100)
    return NavierStokes(None, ds, domain_size=n, batch_size=2, Re=100,
                        fused_kernels=fused, pressure_gauge=gauge), ds


def ns_gmres(F, x0, **kw):
    """GMRES on F's Jacobian action at x0 (dicts of fields), its right-hand
    side -F(x0): one Newton direction."""
    keys = ("u", "v", "p")
    x = torch.stack([x0[k] for k in keys])

    def Fs(y):
        R = F(dict(zip(keys, y.unbind(0))))
        return torch.stack([R[k] for k in keys])

    def Jv(v):
        return torch.func.jvp(Fs, (x,), (v,))[1]

    from diffnet_tpu_torch.train import krylov
    return krylov.gmres(Jv, -Fs(x), **kw)[0]


def flow_rank(rank: int, world: int, p: dict) -> dict:
    out = {}
    mesh = make_mesh(data=2, space=world // 2)
    n = p["u"].shape[-1]

    def block(a, axis=1):
        return torch.tensor(local_block(local_block(a, mesh, 0, "data"),
                                        mesh, axis, "space")).contiguous()

    inputs = block(p["inputs"])
    for fused in (False, True):
        for gauge in ("mean-control", "dirichlet"):
            m, _ = ns_module(n, fused, gauge)
            fields = [block(p[k]).requires_grad_(True) for k in "uvp"]
            R = m.calc_residuals(tuple(fields), inputs, None, mesh)
            Rm = m.mixed_residual(dict(zip("uvp", fields)), inputs, None,
                                  mesh)
            # the fields' VJP of a share of <w, R> (each rank its rows)
            w = [block(p["w"][i]) for i in range(3)]
            share = sum((a * b).sum() for a, b in zip(Rm.values(), w))
            grads = torch.autograd.grad(share, fields)
            out[fused, gauge] = {
                "calc": [t.detach().numpy() for t in R],
                "mixed": [t.detach().numpy() for t in Rm.values()],
                "vjp": [g.numpy() for g in grads]}
    # GMRES on the Jacobian action of the mean-control residual (one
    # sample a data rank), through K6's entry
    m, _ = ns_module(n, True)
    x0 = {k: block(p[k])[:1] for k in "uvp"}
    sub = inputs[:1]
    # the mean control's all-reduce and the halo exchange under
    # torch.func.jvp, inner products all-reduced over 'space'
    dx = ns_gmres(lambda f: m.mixed_residual(f, sub, None, mesh), x0,
                  mesh=mesh, **GMRES["ns"])
    out["gmres"] = dx.numpy()
    out["stokes"] = stokes_gmres(mesh)
    return out


def stokes_gmres(mesh=None) -> dict:
    """One GMRES(10) cycle of ``solve_linear`` on the 17^2 Stokes MMS
    system (a dict of fields, its forcing at the Gauss points), whole or
    with the rows split over `mesh` (17 rows: blocks of 8 and 9)."""
    from diffnet_tpu_torch.data import StokesMMSDataset
    from diffnet_tpu_torch.pde import StokesMMS

    n = 17
    ds = StokesMMSDataset(n)
    m = StokesMMS(None, ds, domain_size=n, batch_size=1, Re=1)
    inputs = _t(ds[0][0])[None]
    if mesh is not None:
        inputs = local_block(inputs, mesh, 1, "space").contiguous()

    def resfn(fields):
        R = m.residual_for_field({k: v[None] for k, v in fields.items()},
                                 inputs, None, mesh)
        return {k: v[0] for k, v in R.items()}

    tmpl = {k: torch.zeros(inputs.shape[1:3]) for k in "uvp"}
    sol, _ = solve_linear(resfn, tmpl, method="gmres", device="cpu",
                          mesh=mesh, **GMRES["ns"])
    return {k: v.numpy() for k, v in sol.items()}


def flow_one_process(p: dict) -> dict:
    """flow_rank's references in one process, on the whole fields."""
    out = {}
    n = p["u"].shape[-1]
    inputs = _t(p["inputs"])
    for fused in (False, True):
        for gauge in ("mean-control", "dirichlet"):
            m, _ = ns_module(n, fused, gauge)
            fields = [_t(p[k]).requires_grad_(True) for k in "uvp"]
            Rm = m.mixed_residual(dict(zip("uvp", fields)), inputs, None)
            share = sum((a * _t(b)).sum() for a, b in zip(Rm.values(),
                                                           p["w"]))
            grads = torch.autograd.grad(share, fields)
            out[fused, gauge] = {
                "mixed": [t.detach().numpy() for t in Rm.values()],
                "vjp": [g.numpy() for g in grads]}
    out["stokes"] = stokes_gmres()
    m, _ = ns_module(n, True)
    out["gmres"] = [ns_gmres(
        lambda f, i=i: m.mixed_residual(f, inputs[i:i + 1], None),
        {k: _t(p[k])[i:i + 1] for k in "uvp"}, **GMRES["ns"]).numpy()
        for i in range(2)]
    return out


def poisson_gmres_one_process(s: dict) -> np.ndarray:
    """solvers_rank's split GMRES run in one process."""
    n = s["b"].shape[0]
    basis = fem.BasisTables(make_basis(2, 1, h=(1 / (n - 1),) * 2))
    resfn = poisson_varnu(n, *(_t(s[k]) for k in ("nu", "bc", "b")), basis)
    return solve_linear(resfn, (n, n), method="gmres", device="cpu",
                        **GMRES["poisson"])[0].numpy()



# ---------------------------------------------------------------------------
# tests/test_torch_parallel_global.py


class Arrays:
    """Items ``(a[i], b[i], ...)`` of equal-length arrays."""

    def __init__(self, *arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)


def global_module(name: str, p: dict):
    """One of the four modules whose loss is a root of a sum over the
    batch (or such a sum plus a batch mean), from the payload's start."""
    from diffnet_tpu_torch.models import VAE
    from diffnet_tpu_torch.pde import Eikonal2D, ElasticFSDT, IBNPoisson2D

    n = p["n"]
    if name == "flow":
        return NavierStokes(DirectField((n, n), init=p["field0"],
                                        n_fields=3), None, domain_size=n,
                            batch_size=p["batch"], Re=100)
    if name == "plate":
        return ElasticFSDT(DirectField((n, n), init=p["field0"],
                                       n_fields=3), None, domain_size=n,
                           batch_size=p["batch"])
    if name == "eikonal":
        return Eikonal2D(DirectField((n, n), init=p["field0"]), None,
                         domain_size=n, batch_size=p["batch"])
    net = VAE(1, 1, dims=2, n_downsample=2, latent_channels=4)
    net.load_state_dict({k: torch.tensor(v) for k, v in p["vae"].items()})
    return IBNPoisson2D(net, domain_size=n, batch_size=p["batch"],
                        ibn_loss_type="resmin", vae_kl_weight=0.05)


def global_fit(name: str, p: dict, mesh=None, optimizer="adam",
               val_on_mesh=False) -> dict:
    """One Adam step (lr 1e-3; or one 5-iteration LBFGS step) of `name`'s
    module on the payload's global batch through Trainer.fit, or on this
    rank's rows of it over `mesh`: the loss, the gradient of the step's
    last evaluation (the all-reduced one over a mesh), the parameters
    after it, and the epoch's validation loss on the global batch, whole
    on every rank or (`val_on_mesh`) this rank's rows of it over `mesh`."""
    from diffnet_tpu_torch.data import NumpyLoader
    from diffnet_tpu_torch.train import Callback, Trainer

    class Metrics(Callback):
        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.metrics = metrics

    m = global_module(name, p)
    arrays = p["batches"][name]
    loader = NumpyLoader(Arrays(*arrays), batch_size=len(arrays[0]),
                         mesh=mesh)
    val = NumpyLoader(Arrays(*arrays), batch_size=len(arrays[0]),
                      mesh=mesh if val_on_mesh else None)
    seen = Metrics()
    tr = Trainer(max_epochs=1, optimizer=optimizer, learning_rate=1e-3,
                 lbfgs_max_iter=5, device="cpu", callbacks=[seen])
    tr.fit(m, loader, val_dataloader=val)
    net = m.network
    return {"loss": tr.step_losses[0],
            "val_loss": seen.metrics["val_loss"],
            "grad": {k: v.grad.numpy().copy()
                     for k, v in net.named_parameters()},
            "params": {k: v.detach().numpy().copy()
                       for k, v in net.named_parameters()},
            "reduction": m.batch_reduction}


def global_rank(rank: int, world: int, p: dict) -> dict:
    mesh = make_mesh(data=world)
    out = {name: global_fit(name, p, mesh) for name in p["batches"]}
    out["plate_lbfgs"] = global_fit("plate", p, mesh, "lbfgs",
                                    val_on_mesh=True)
    return out
