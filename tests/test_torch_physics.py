"""The port's remaining single-instance physics against the JAX package's,
on the same seeded numpy inputs: Helmholtz, SUPG advection-diffusion, the
space-time heat, Allen-Cahn and Burgers formulations, the two-dof Poisson
strong form, their datasets, an indefinite Helmholtz Krylov solve, the
affine first stage of the Allen-Cahn homotopy, and short training runs.

Tolerances: every loss and its gradient in the field in float64 (JAX
under ``enable_x64``) within 1e-10 of the largest |JAX value| (the same
contractions in another order), and in float32 within 1e-5 relative (the
loss; the gradient of its largest entry); datasets bit-equal (the same
numpy code); Krylov solutions within 1e-4 of the largest |JAX value|
(float32 Krylov iterations whose matvecs sum in another order); Adam
losses within 1e-5 relative, as the Poisson trainer test; LBFGS by its
final rel L2 error, within 10% of the JAX Trainer's (both run optax's
L-BFGS, whose float32 runs part within a few updates).
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.data import geometry_datasets as jgd
from diffnet_tpu.data import single_instances as jsi
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde import advection as jadv
from diffnet_tpu.pde import helmholtz as jhel
from diffnet_tpu.pde import poisson as jpoi
from diffnet_tpu.pde import spacetime as jst
from diffnet_tpu.train import linear as jlin
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.data import geometry_datasets as tgd
from diffnet_tpu_torch.data import single_instances as tsi
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.pde import (AdvDiff2D, AllenCahnIceMelt,
                                   BurgersSpaceTime, Helmholtz2D,
                                   PoissonTwoDof2D, SpaceTimeHeat)
from diffnet_tpu_torch.train import Callback, Trainer
from diffnet_tpu_torch.train import linear as tlin

F64_TOL = 1e-10
F32_RTOL = 1e-5
SOLVE_TOL = 1e-4
PI = math.pi


def _sin_sin(x, y):
    return np.sin(PI * x) * np.sin(PI * y)


# -- datasets ----------------------------------------------------------------

DATASETS = ["RectangleManufacturedNonZeroBC", "SpaceTimeRectangleManufactured",
            "AdvDiff1dRectangle", "AdvDiff2dRectangle",
            "AllenCahnIceMeltRectangle", "RectangleHelmholtzManufactured",
            "RectangleHelmholtzDeltaForce", "RectangleManufacturedStokes"]


@pytest.mark.parametrize("name", DATASETS + ["Burg2DXT"])
def test_datasets_are_bit_equal(name):
    """Every array attribute and the sample equal JAX's, bit for bit (the
    seeded draws of SpaceTimeRectangleManufactured included)."""
    jmod, tmod = (jgd, tgd) if name == "Burg2DXT" else (jsi, tsi)
    for n in (17, 24):
        j, t = getattr(jmod, name)(domain_size=n), getattr(tmod, name)(
            domain_size=n)
        arrays = {k for k, v in vars(j).items() if isinstance(v, np.ndarray)}
        assert arrays == {k for k, v in vars(t).items()
                          if isinstance(v, np.ndarray)}
        for k in arrays:
            assert np.array_equal(getattr(t, k), getattr(j, k)), k
            assert getattr(t, k).dtype == getattr(j, k).dtype, k
        for a, b in zip(t[0], j[0]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(t) == len(j)
        for k in ("khh", "ac_A", "ac_Cn", "ac_D", "ac_k", "diffusivity",
                  "decay_rt"):
            assert getattr(t, k, None) == getattr(j, k, None), k


def test_spacetime_dataset_draws_follow_the_seed():
    a = tsi.SpaceTimeRectangleManufactured(domain_size=9, seed=3)
    b = jsi.SpaceTimeRectangleManufactured(domain_size=9, seed=3)
    c = tsi.SpaceTimeRectangleManufactured(domain_size=9, seed=4)
    assert np.array_equal(a.domain, b.domain)
    assert np.array_equal(a.initial_guess, b.initial_guess)
    assert not np.array_equal(a.domain, c.domain)


# -- module losses and their gradients ---------------------------------------

def _stack(*chans):
    return np.stack(chans, -1)[None]


def _case(name, n, rng):
    """(JAX module, port module, inputs [2, ny, nx, C], forcing [2, ny, nx,
    1], field shape) for a named configuration."""
    walls = np.zeros((n, n))
    walls[[0, -1], :] = 1
    walls[:, [0, -1]] = 1
    ones = np.ones((n, n))
    forcing_t = rng.standard_normal((1, n, n, 1))
    kw = {"domain_size": n, "batch_size": 2}
    if name.startswith("helmholtz"):
        k = 12.0 if name == "helmholtz_k12" else 0.5
        f = (lambda x, y: (2 * PI**2 - k**2) * _sin_sin(x, y)) \
            if name == "helmholtz_forcing" else None
        inputs = _stack(ones, 0 * ones, walls)
        mods = [cls(None, None, khh=k, forcing=f, **kw)
                for cls in (jhel.Helmholtz2D, Helmholtz2D)]
    elif name.startswith("advdiff"):
        ds = tsi.AdvDiff2dRectangle(domain_size=n)
        nu = 1.0 + 0.5 * rng.random((n, n))          # varying channel 0
        inputs = _stack(nu, ds.bc1, ds.bc2)
        f = (lambda x, y: np.cos(x) * y) if name == "advdiff_forcing" \
            else None
        mods = [cls(None, None, diffusivity=0.05, forcing=f, bc1_value=0.7,
                    **kw) for cls in (jadv.AdvDiff2D, AdvDiff2D)]
    elif name.startswith("heat"):
        _, loss_type, tau = name.split("_")
        nx, ny = n, n - 4                         # non-square: hx != hy
        ds = tsi.SpaceTimeRectangleManufactured(domain_size=n)
        inputs = _stack(ds.domain, ds.bc1, ds.bc2)[:, :ny]
        forcing_t = forcing_t[:, :ny]
        u0 = ds.u0[:ny]
        tau = float(tau) if tau[0].isdigit() else tau
        f = (lambda x, y: np.sin(PI * x) * np.exp(-y)) \
            if loss_type == "energy" else None
        mods = [cls(None, None, domain_sizes=(nx, ny), batch_size=2,
                    loss_type=loss_type, tau=tau, u0=u0, forcing=f)
                for cls in (jst.SpaceTimeHeat, SpaceTimeHeat)]
        return (*mods, np.repeat(inputs, 2, 0), np.repeat(forcing_t, 2, 0),
                (ny, nx))
    elif name.startswith("allencahn"):
        A = float(name.split("_")[1])
        ds = tsi.AllenCahnIceMeltRectangle(domain_size=n)
        inputs = _stack(ds.domain, ds.bc1, walls)
        f = lambda x, y: _sin_sin(x, y) + y          # noqa: E731
        mods = [cls(None, ds, ac_A=A, forcing=f, **kw)
                for cls in (jst.AllenCahnIceMelt, AllenCahnIceMelt)]
    elif name.startswith("burgers"):
        ds = tgd.Burg2DXT(domain_size=n)
        inputs = ds.inputs[None].astype(np.float64)
        visc = 0.01 if name == "burgers_viscous" else 0.0
        f = (lambda x, y: np.sin(PI * x) * np.exp(-y)) if visc else None
        mods = [cls(None, None, viscosity=visc, forcing=f,
                    domain_lengths=(2.0, 1.0), **kw)
                for cls in (jst.BurgersSpaceTime, BurgersSpaceTime)]
    else:   # two-dof Poisson: three fields
        inputs = _stack(1.0 + 0.5 * rng.random((n, n)), 0 * ones, walls)
        mods = [cls(None, None, **kw)
                for cls in (jpoi.PoissonTwoDof2D, PoissonTwoDof2D)]
        return (*mods, np.repeat(inputs, 2, 0), np.repeat(forcing_t, 2, 0),
                (3, n, n))
    return (*mods, np.repeat(inputs, 2, 0), np.repeat(forcing_t, 2, 0),
            (n, n))


CASES = ["helmholtz", "helmholtz_forcing", "helmholtz_k12", "advdiff",
         "advdiff_forcing", "heat_resmin_pe", "heat_resmin_reference",
         "heat_resmin_0.01", "heat_energy_pe", "heat_energy_reference",
         "heat_energy_0.01", "allencahn_0", "allencahn_16", "burgers",
         "burgers_viscous", "twodof"]


def _split(u, name):
    """The two-dof module takes its three fields [2, 3, n, n] as a
    tuple."""
    return tuple(u[:, i] for i in range(3)) if name == "twodof" else u


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_loss_and_gradient_match_jax(name, dtype):
    """Each module's loss, and its gradient in the field, at a seeded
    random field on 17^2 (the heat cases on 17 x 13 nodes)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    jm, tm, inputs, forcing, shape = _case(name, 17, rng)
    u = rng.standard_normal((2,) + shape)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    u, inputs, forcing = (a.astype(np_dtype) for a in (u, inputs, forcing))

    def jloss(v, i, fo):
        return jm.loss(_split(v, name), i, fo)

    with jax.enable_x64(dtype == "float64"):
        jl, jg = jax.jit(jax.value_and_grad(jloss))(
            *map(jnp.asarray, (u, inputs, forcing)))
        jl, jg = float(jl), np.asarray(jg)
    tu = torch.from_numpy(u).requires_grad_()
    tl = tm.loss(_split(tu, name), torch.from_numpy(inputs),
                 torch.from_numpy(forcing))
    tl.backward()
    assert tl.dtype == tu.dtype and tu.grad.shape == jg.shape
    if dtype == "float64":
        assert abs(tl.item() - jl) <= F64_TOL * max(1.0, abs(jl))
        np.testing.assert_allclose(tu.grad.numpy(), jg, rtol=0,
                                   atol=F64_TOL * max(1.0, np.abs(jg).max()))
    else:
        assert abs(tl.item() - jl) <= F32_RTOL * abs(jl)
        np.testing.assert_allclose(tu.grad.numpy(), jg, rtol=0,
                                   atol=F32_RTOL * np.abs(jg).max())


def test_residual_for_field_and_apply_bcs_match_jax():
    """Helmholtz's affine residual map, and the boundary substitution of
    every module that has one, in float64."""
    rng = np.random.default_rng(5)
    with jax.enable_x64(True):
        for name in ("helmholtz_k12", "advdiff", "heat_resmin_pe",
                     "allencahn_16", "burgers", "twodof"):
            jm, tm, inputs, forcing, shape = _case(name, 17, rng)
            u = rng.standard_normal((2,) + shape)
            ju, ti = _split(jnp.asarray(u), name), torch.from_numpy(inputs)
            want = jm.apply_bcs(ju, jnp.asarray(inputs))
            got = tm.apply_bcs(_split(torch.from_numpy(u), name), ti)
            for a, b in zip(jax.tree.leaves(want), (
                    got if isinstance(got, tuple) else (got,))):
                assert np.array_equal(b.numpy(), np.asarray(a)), name
            if name == "helmholtz_k12":
                want = jm.residual_for_field(ju, jnp.asarray(inputs),
                                             jnp.asarray(forcing))
                got = tm.residual_for_field(torch.from_numpy(u), ti,
                                            torch.from_numpy(forcing))
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), rtol=0,
                    atol=F64_TOL * np.abs(np.asarray(want)).max())


def test_allen_cahn_without_reaction_is_affine():
    """With ac_A = 0 the reaction is dropped from the expression: the
    residual is exactly affine (float64), and solve_linear accepts it and
    lands on the exact discrete solution of JAX's residual map (a dense
    float64 solve; the Dirichlet rows and columns are zero, so the
    least-squares solution is 0 there, as the Krylov one)."""
    n = 17
    ds = tsi.AllenCahnIceMeltRectangle(domain_size=n)
    ds.n_samples = 1
    ds.bc2 = np.zeros((n, n))
    ds.bc2[:, [0, -1]] = 1.0
    ds.bc2[-1, :] = 1.0
    ds.u0 = np.zeros((n, n))
    inputs = ds[0][0][None]
    f = lambda x, y: PI * np.sin(PI * x) * np.cos(PI * y)   # noqa: E731
    tm = AllenCahnIceMelt(None, ds, domain_size=n, batch_size=1, ac_A=0.0,
                          forcing=f, u0=ds.u0)
    jm = jst.AllenCahnIceMelt(None, ds, domain_size=n, batch_size=1,
                              ac_A=0.0, forcing=f, u0=ds.u0)
    ti, ji = torch.from_numpy(inputs), jnp.asarray(inputs)

    def tF(u):
        return tm.residual(tm.apply_bcs(u[None], ti), ti[..., 1],
                           ti[..., 2])[0]

    def jF(u):
        return jm.residual(jm.apply_bcs(u[None], ji), ji[..., 1],
                           ji[..., 2])[0]

    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((n, n))) for _ in range(2))
    lin = tF(a + b) - tF(a) - tF(b) + tF(0 * a)
    assert float(lin.abs().max()) < 1e-12
    tu, _ = tlin.solve_linear(tF, (n, n), method="gmres", tol=1e-6,
                              maxiter=40, restart=30, device="cpu")
    with jax.enable_x64(True):    # JAX's operator as a dense float64 matrix
        z = jnp.zeros((n, n), jnp.float64)
        J = np.asarray(jax.jit(jax.jacfwd(jF))(z)).reshape(n * n, n * n)
        b = -np.asarray(jax.jit(jF)(z)).reshape(-1)
    ju = np.linalg.lstsq(J, b, rcond=None)[0].reshape(n, n)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=0,
                               atol=SOLVE_TOL * np.abs(ju).max())


def test_helmholtz_indefinite_gmres_solve_matches_jax():
    """k = 12 (indefinite) through module_linear_solve(method='gmres'), as
    the JAX package's own test configures it, at 17^2 and to tol 1e-6 (its
    1e-10 is below float32's reach, so both solvers would run all of
    maxiter)."""
    n, k = 17, 12.0
    f = lambda x, y: (2 * PI**2 - k**2) * _sin_sin(x, y)   # noqa: E731
    ds = tsi.RectangleHelmholtzManufactured(domain_size=n, khh=k)
    ds.n_samples = 1
    jm = jhel.Helmholtz2D(JDirectField((n, n)), ds, domain_size=n,
                          batch_size=1, khh=k, exact_solution=ds.exact,
                          forcing=f)
    tm = Helmholtz2D(DirectField((n, n)), ds, domain_size=n, batch_size=1,
                     khh=k, exact_solution=ds.exact, forcing=f)
    assert tm.khh == k
    ju, _ = jlin.module_linear_solve(jm, method="gmres", tol=1e-6,
                                     maxiter=200)
    tu, _ = tlin.module_linear_solve(tm, method="gmres", tol=1e-6,
                                     maxiter=200, device="cpu")
    ju = np.asarray(ju)
    np.testing.assert_allclose(tu, ju, rtol=0,
                               atol=SOLVE_TOL * np.abs(ju).max())
    eL2, _, uex = tm.calc_l2_err(torch.from_numpy(tu))
    assert float(eL2 / uex) < 0.1


# -- training -----------------------------------------------------------------

class _JLosses(JCallback):
    def __init__(self):
        self.losses = []

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])


class _TLosses(Callback):
    def __init__(self):
        self.losses = []

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])


def _helmholtz_pair(n):
    ds = tsi.RectangleHelmholtzManufactured(domain_size=n)
    ds.n_samples = 1
    init = np.random.default_rng(2).random((n, n)).astype(np.float32)
    jm = jhel.Helmholtz2D(JDirectField((n, n), init=init), ds, domain_size=n,
                          batch_size=1, exact_solution=ds.exact)
    tm = Helmholtz2D(DirectField((n, n), init=init), ds, domain_size=n,
                     batch_size=1, exact_solution=ds.exact)
    return jm, tm


def test_helmholtz_adam_run_matches_jax_trainer():
    """5 Adam epochs at 17^2 from a seeded field: the losses and the field
    step for step."""
    jm, tm = _helmholtz_pair(17)
    jcb, tcb = _JLosses(), _TLosses()
    jst_ = JTrainer(max_epochs=5, optimizer="adam", learning_rate=1e-2,
                    callbacks=[jcb]).fit(jm)
    tst = Trainer(max_epochs=5, optimizer="adam", learning_rate=1e-2,
                  callbacks=[tcb], device="cpu").fit(tm)
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=F32_RTOL)
    np.testing.assert_allclose(tst.params["field"].numpy(),
                               np.asarray(jst_.params["field"]), rtol=1e-5,
                               atol=1e-6)


def test_helmholtz_lbfgs_run_reaches_jax_trainers_error():
    """5 LBFGS epochs (10 iterations each) at 17^2: the final rel L2
    against the exact solution within 10% of the JAX Trainer's."""
    jm, tm = _helmholtz_pair(17)
    jst_ = JTrainer(max_epochs=5, optimizer="lbfgs",
                    lbfgs_max_iter=10).fit(jm)
    Trainer(max_epochs=5, optimizer="lbfgs", lbfgs_max_iter=10,
            device="cpu").fit(tm)
    eL2, _, uex = jm.calc_l2_err(
        jm.apply_dirichlet(jm.network.apply(jst_.params)[0],
                           jnp.asarray(jm.dataset.bc2), 0.0))
    rel_j = float(eL2 / uex)
    with torch.no_grad():
        u = tm.apply_dirichlet(tm.network()[0],
                               torch.from_numpy(tm.dataset.bc2), 0.0)
        eL2, _, uex = tm.calc_l2_err(u)
    rel_t = float(eL2 / uex)
    assert abs(rel_t - rel_j) <= 0.1 * rel_j, (rel_t, rel_j)


def test_chip_smoke_and_the_jax_reference_script_build_one_problem():
    """chip_smoke.py's slice L holds the port to the figures of
    scripts/torch_port_reference_physics.py: both build their cases from
    scripts/torch_port_reference_physics_cases.py, and JAX_L holds every
    figure the script prints."""
    import importlib.util
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    saved = list(sys.path)
    sys.path.insert(0, str(root))
    try:
        import chip_smoke as cs
        import torch_port_reference_physics_cases as pc

        spec = importlib.util.spec_from_file_location(
            "torch_port_reference_physics",
            root / "scripts/torch_port_reference_physics.py")
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
    finally:
        sys.path[:] = saved
    shared = [k for k in vars(pc) if not k.startswith("_")
              and k not in ("annotations", "math", "np", "PI", "FIGURES")]
    for mod in (cs, ref):
        used = [k for k in shared if hasattr(mod, k)]
        assert len(used) > 40, (mod.__name__, used)
        for k in used:
            assert getattr(mod, k) is getattr(pc, k), (mod.__name__, k)
    assert set(cs.JAX_L) == set(pc.FIGURES)
