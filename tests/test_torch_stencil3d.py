"""The port's 27-point stencil path (K4-3D's plain version and autograd, 3D
extraction, and the 3D multigrid-preconditioned CG solve) against the JAX
package's, on the same numpy inputs.

The JAX Pallas 3D apply runs in interpret mode (the monkeypatch of
tests/test_stencil_apply_kernel.py); the port's K4 wrapper runs its plain
version on the CPU. Tolerances: fields at atol 2e-6 times max(1, max
|ref|) (O(1) float32 stencils summed in another order, the JAX tests' own
tolerance); one V-cycle ``M(b)`` at 1e-4 of its largest entry (float32
smoothing over four levels, summed in other orders); MG-CG relative
residuals, which sit near the float32 floor, within 2x of JAX's and under
JAX's own test limit.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffnet_tpu.data.single_instances import (
    CuboidManufactured as JCuboidManufactured)
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.ops.stencil_apply import (
    stencil_transpose_planes as jtranspose)
from diffnet_tpu.pde.poisson import Poisson3D as JPoisson3D
from diffnet_tpu.train import linear as jlin
from diffnet_tpu.train import stencil as jst
from diffnet_tpu_torch.data import CuboidManufactured
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.ops import stencil_apply as k4
from diffnet_tpu_torch.pde import Poisson3D
from diffnet_tpu_torch.train import linear
from diffnet_tpu_torch.train import stencil as tst


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _rand(rng, shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _close(a, b, atol=2e-6):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=atol * max(1.0, float(np.abs(b).max())))


SHAPES = [(2, 9, 9, 9), (1, 10, 12, 14)]


@pytest.mark.parametrize("shared_c", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_3d_matches_jax_kernel(shape, shared_c):
    """K4's wrapper on CPU tensors (its plain version) against the JAX
    Pallas 3D apply; a batch-1 C goes through JAX's ``stencil_matvec``
    route, which broadcasts it to the batch."""
    rng = np.random.default_rng(0)
    B = shape[0]
    C = _rand(rng, (27, 1 if shared_c else B) + shape[1:])
    u = _rand(rng, shape)
    want = jst.stencil_matvec(jnp.asarray(C), jnp.asarray(u), nsd=3,
                              kernel="dma")
    before = (k4.launches, k4.launches_3d)
    got = k4.stencil_apply(torch.from_numpy(C), torch.from_numpy(u), nsd=3)
    assert (k4.launches, k4.launches_3d) == before
    _close(got, want)
    _close(k4.apply_3d(torch.from_numpy(C), torch.from_numpy(u)), want)


@pytest.mark.parametrize("shape", [(2, 9, 9, 9), (1, 5, 7, 6)])
def test_transpose_planes_3d_match_jax(shape):
    C = _rand(np.random.default_rng(2), (27,) + shape)
    got = k4.stencil_transpose_planes(torch.from_numpy(C), 3)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jtranspose(jnp.asarray(C), 3)))


@pytest.mark.parametrize("shared_c", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_3d_matches_jax_vjp(shape, shared_c):
    """du (the apply of the transposed planes) and dC (g times shifted u)
    against the JAX custom VJP; a batch-1 C sums its cotangent over the
    batch."""
    rng = np.random.default_rng(3)
    B = shape[0]
    C = _rand(rng, (27, 1 if shared_c else B) + shape[1:])
    u, g = _rand(rng, shape), _rand(rng, shape)
    jg = jnp.asarray(g)
    gC_j, gu_j = jax.grad(
        lambda C, u: jnp.sum(jst.stencil_matvec(C, u, nsd=3, kernel="dma")
                             * jg), argnums=(0, 1))(jnp.asarray(C),
                                                    jnp.asarray(u))
    tC = torch.tensor(C, requires_grad=True)
    tu = torch.tensor(u, requires_grad=True)
    (k4.stencil_apply_3d(tC, tu) * torch.from_numpy(g)).sum().backward()
    _close(tu.grad, gu_j)
    _close(tC.grad, gC_j)


def test_apply_3d_rejects_what_the_kernel_does_not_take():
    C, u = torch.zeros(27, 2, 4, 5, 6), torch.zeros(2, 4, 5, 6)
    with pytest.raises(ValueError, match="C must be"):
        k4.stencil_apply(C[:9], u, nsd=3)
    with pytest.raises(ValueError, match="C must be"):
        k4.stencil_apply(torch.zeros(27, 3, 4, 5, 6), u, nsd=3)
    with pytest.raises(ValueError, match=r"u must be \[B, nz, ny, nx\]"):
        k4.stencil_apply(C, u[0], nsd=3)
    with pytest.raises(TypeError, match="float32"):
        k4.stencil_apply(C.double(), u.double(), nsd=3)
    with pytest.raises(ValueError, match="contiguous"):
        k4.stencil_apply(C, torch.zeros(2, 4, 6, 5).transpose(2, 3), nsd=3)
    with pytest.raises(ValueError, match="nsd must be 2 or 3"):
        k4.stencil_apply(C, u, nsd=4)
    with pytest.raises(ValueError, match="not supported"):
        k4.apply_3d(C.to("meta"), u.to("meta"))


# ---------------------------------------------- extraction and solves ----

def _exact(x, y, z):
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)


def _forcing(x, y, z):
    return 3 * np.pi**2 * _exact(x, y, z)


def test_extraction_3d_27_point_matches_jax():
    """tests/test_stencil.py's 27-point case at 17^3: the extracted stencil
    equals JAX's, reproduces the matrix-free operator, and CG over it (through
    K4-3D's wrapper) solves the MMS problem as JAX does."""
    n = 17
    kw = dict(domain_size=n, batch_size=1, loss_type="resmin",
              exact_solution=_exact, forcing=_forcing, mms_dirichlet=True)
    jds, tds = JCuboidManufactured(n), CuboidManufactured(n)
    jds.n_samples = tds.n_samples = 1
    jm = JPoisson3D(JDirectField((n,) * 3), jds, **kw)
    tm = Poisson3D(DirectField((n,) * 3), tds, **kw)
    inputs, fz = tds[0]
    ji, jf = jnp.asarray(inputs)[None], jnp.asarray(fz)[None]
    ti, tf = torch.from_numpy(inputs)[None], torch.from_numpy(fz)[None]
    jb0 = jm.residual_for_field(jnp.zeros((1, n, n, n)), ji, jf)[0]
    tb0 = tm.residual_for_field(torch.zeros(1, n, n, n), ti, tf)[0]

    def jA(u):
        return jm.residual_for_field(u[None], ji, jf)[0] - jb0

    def tA(u):
        return tm.residual_for_field(u[None], ti, tf)[0] - tb0

    Cj = jst.extract_stencil(jA, (n,) * 3)
    Ct = tst.extract_stencil(tA, (n,) * 3, device="cpu")
    assert tuple(Ct.shape) == (27, n, n, n)
    _close(Ct, Cj)
    u = np.random.default_rng(4).standard_normal((n,) * 3).astype(np.float32)
    want = tA(torch.from_numpy(u))
    got = tst.stencil_matvec(Ct, torch.from_numpy(u), kernel="cuda")
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < 1e-5
    u_j, _ = jlin.module_linear_solve(jm, tol=1e-10, assemble="stencil")
    u_t, _ = linear.module_linear_solve(tm, tol=1e-10, assemble="stencil",
                                        stencil_kernel="cuda", device="cpu")
    eL2, _, uex = tm.calc_l2_err(torch.from_numpy(u_t))
    assert float(eL2 / uex) < 2e-2
    np.testing.assert_allclose(u_t, np.asarray(u_j), atol=1e-5)


def _walls(n):
    bc = np.zeros((n, n, n))
    bc[[0, -1]] = 1
    bc[:, [0, -1]] = 1
    bc[:, :, [0, -1]] = 1
    return bc


def _rhs(n, bc, seed=0):
    b = np.random.default_rng(seed).standard_normal((n, n, n))
    return np.where(bc > 0.5, 0.0, b).astype(np.float32)


def _solve_both(factories, n, b, mg_kw, maxiter):
    """MG-CG in both packages on the factories' fine module: relative
    residuals and one V-cycle M(b) of each."""
    out = {}
    for name, factory, lin, asarr, norm, dev in (
            ("jax", factories[0], jlin, jnp.asarray, jnp.linalg.norm, {}),
            ("torch", factories[1], linear, torch.from_numpy,
             torch.linalg.norm, {"device": "cpu"})):
        m = factory(n)
        inputs, forcing = (asarr(a)[None] for a in m.dataset[0])
        bb = asarr(b)

        def resfn(u, m=m, inputs=inputs, forcing=forcing, bb=bb):
            return m.residual_for_field(u[None], inputs, forcing)[0] - bb

        M, info = lin.multigrid_preconditioner(factory, n, nsd=3, **mg_kw,
                                               **dev)
        u, _ = lin.solve_linear(resfn, (n,) * 3, tol=1e-12, maxiter=maxiter,
                                M=M, **dev)
        out[name] = (float(norm(resfn(u)) / norm(bb)),
                     np.asarray(M(bb)), info["levels"])
    return out


def test_multigrid_3d_matches_jax():
    """tests/test_linear_solve.py's 3D MG-CG at 17^3 (CuboidManufactured,
    trilinear transfers, probed coarse pinv at 9^3), 10 iterations; the
    ``stencil_kernel`` knob (K4-3D's wrapper, plain on the CPU) changes
    where the apply runs, not what it computes."""
    n = 17

    def make(P, D, F):
        def factory(m_n):
            ds = F(domain_size=m_n)
            ds.n_samples = 1
            return P(D((m_n,) * 3), ds, domain_size=m_n, batch_size=1,
                     loss_type="resmin")
        return factory

    facs = (make(JPoisson3D, JDirectField, JCuboidManufactured),
            make(Poisson3D, DirectField, CuboidManufactured))
    b = _rhs(n, _walls(n))
    res = _solve_both(facs, n, b, {}, maxiter=10)
    (r_j, Mb_j, lv_j), (r_t, Mb_t, lv_t) = res["jax"], res["torch"]
    assert lv_t == lv_j == [17, 9]
    assert r_j < 1e-4 and r_t < 1e-4 and r_t < 2 * r_j, (r_t, r_j)
    _close(Mb_t, Mb_j, atol=1e-4)
    Mk, _ = linear.multigrid_preconditioner(facs[1], n, nsd=3,
                                            stencil_kernel="cuda",
                                            device="cpu")
    _close(Mk(torch.from_numpy(b)), Mb_j, atol=1e-4)


class _VarNuDS3D:
    """One variable-nu 3D instance, source on the x = 0 face, sink on the
    x = 1 face, zero forcing (tests/test_linear_solve.py's
    ``_VarNuDataset3D``)."""

    def __init__(self, nu):
        n = nu.shape[0]
        b1 = np.zeros((n, n, n)); b1[:, :, 0] = 1
        b2 = np.zeros((n, n, n)); b2[:, :, -1] = 1
        self.inputs = np.stack([nu, b1, b2], -1).astype(np.float32)
        self.forcing = np.zeros((n, n, n, 1), np.float32)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def test_multigrid_galerkin_variable_nu_3d_matches_jax():
    """tests/test_linear_solve.py's Galerkin-RAP MG-CG at 17^3: a ~50x
    contrast nu known only on the fine level, restricted inputs, 8
    iterations; the port's residual within 2x of JAX's and under its 3e-5."""
    from scipy import ndimage

    n = 17
    rng = np.random.default_rng(5)
    g = ndimage.gaussian_filter(rng.standard_normal((33, 33, 33)), 3.3)
    nu = np.exp(2.0 * g / np.abs(g).max()).astype(np.float32)[::2, ::2, ::2]
    fine = _VarNuDS3D(nu)

    def make(P, D):
        cache = {}

        def factory(m_n):
            if m_n not in cache:
                ds = fine if m_n == n else _VarNuDS3D(
                    np.ones((m_n,) * 3, np.float32))
                cache[m_n] = P(D((m_n,) * 3), ds, domain_size=m_n,
                               batch_size=1, loss_type="resmin")
            return cache[m_n]
        return factory

    bc = np.zeros((n, n, n))
    bc[:, :, [0, -1]] = 1
    b = _rhs(n, bc, seed=6)
    res = _solve_both((make(JPoisson3D, JDirectField),
                       make(Poisson3D, DirectField)), n, b,
                      dict(inputs_per_level="restrict", coarse_op="galerkin"),
                      maxiter=8)
    r_j, r_t = res["jax"][0], res["torch"][0]
    assert r_j < 3e-5 and r_t < 3e-5 and r_t < 2 * r_j, (r_t, r_j)
    _close(res["torch"][1], res["jax"][1], atol=1e-4)


def test_chip_smoke_and_the_jax_reference_script_build_one_problem():
    """chip_smoke.py's slice F holds the port to the JAX package's relres
    from scripts/torch_port_reference_3d.py; each keeps its own copy of the
    problem (chip_smoke imports no JAX), so the two copies must agree."""
    import importlib.util
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference_3d", root / "scripts/torch_port_reference_3d.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    n = 17
    nu = ref.smooth_nu_3d(n)
    np.testing.assert_array_equal(chip_smoke.smooth_nu_3d(n), nu)
    assert 50 < float(nu.max() / nu.min()) < 56
    inst = chip_smoke._VarNuInstance3D(nu)
    inputs, forcing = ref.varnu_instance(nu)
    np.testing.assert_array_equal(inst.inputs, inputs)
    np.testing.assert_array_equal(inst.forcing, forcing)
