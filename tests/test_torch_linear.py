"""The port's linear-solver path (Krylov solvers, continuation transfers,
``train.linear`` and ``utils.precond``) against the JAX package's, on the
same numpy inputs.

Tolerances: Krylov iterates at rtol 1e-4 (float32 recurrences over a few
steps, reductions in other orders), with an atol of 1e-4 of the largest
entry for entries near 0; the same for multigrid step sizes and one V-cycle
``M(b)``; prolongations, which take the same float32 products, at 1e-6 of
the field's scale; solutions of the f32 Krylov floor as each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from diffnet_tpu.data.single_instances import (
    Rectangle as JRectangle, RectangleManufactured as JRectangleManufactured)
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu.train import continuation as jcont
from diffnet_tpu.train import linear as jlin
from diffnet_tpu.utils import precond as jprecond
from diffnet_tpu_torch.data.single_instances import (Rectangle,
                                                     RectangleManufactured)
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.pde import Poisson2D
from diffnet_tpu_torch.train import continuation, krylov, linear
from diffnet_tpu_torch.utils import precond

jsl = jax.scipy.sparse.linalg


def _close(a, b, rtol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()))


# ------------------------------------------------------------ Krylov ----

def _system(kind, shape=(5, 6), seed=0):
    """A float32 operator on fields of `shape`: SPD with condition 100, or
    nonsymmetric (diagonally dominant); b, x0 and a Jacobi M with it."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if kind == "spd":
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = Q @ np.diag(np.geomspace(1.0, 100.0, n)) @ Q.T
    else:
        A = 3.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    A = A.astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    x0 = rng.standard_normal(shape).astype(np.float32)
    dinv = (1.0 / np.diag(A)).reshape(shape).astype(np.float32)
    tA, jA = torch.from_numpy(A), jnp.asarray(A)
    td, jd = torch.from_numpy(dinv), jnp.asarray(dinv)
    ops = {"torch": (lambda v: (tA @ v.reshape(-1)).reshape(shape),
                     lambda v: td * v),
           "jax": (lambda v: (jA @ v.reshape(-1)).reshape(shape),
                   lambda v: jd * v)}
    return ops, b, x0


@pytest.mark.parametrize("method,kind,kw", [
    ("cg", "spd", {"tol": 0.0, "maxiter": 8}),
    ("cg", "spd", {"tol": 1e-4, "maxiter": 60, "M": True}),
    ("bicgstab", "nonsym", {"tol": 0.0, "maxiter": 6}),
    ("bicgstab", "nonsym", {"tol": 1e-5, "maxiter": 40, "M": True}),
    ("gmres", "nonsym", {"tol": 0.0, "maxiter": 2, "restart": 5}),
    ("gmres", "nonsym", {"tol": 1e-5, "maxiter": 3, "M": True}),
])
def test_krylov_matches_jax(method, kind, kw):
    """Same operator, b, x0, tol, maxiter (and M): the same iterate. tol=0
    runs the loop with no host read-back; tol > 0 stops on a read-back."""
    ops, b, x0 = _system(kind)
    kw = dict(kw)
    use_m = kw.pop("M", False)
    tA, tM = ops["torch"]
    jA, jM = ops["jax"]
    x_t, info_t = getattr(krylov, method)(
        tA, torch.from_numpy(b), torch.from_numpy(x0),
        M=tM if use_m else None, **kw)
    x_j, info_j = getattr(jsl, method)(
        jA, jnp.asarray(b), jnp.asarray(x0), M=jM if use_m else None, **kw)
    _close(x_t, x_j)
    if method == "gmres":
        assert int(info_t) == int(info_j) == 0
    else:
        assert info_t is None


def test_krylov_defaults_and_checks():
    ops, b, _ = _system("spd")
    tA, _ = ops["torch"]
    jA, _ = ops["jax"]
    _close(krylov.cg(tA, torch.from_numpy(b), tol=1e-6)[0],
           jsl.cg(jA, jnp.asarray(b), tol=1e-6)[0], rtol=1e-3)
    with pytest.raises(ValueError, match="matching shapes"):
        krylov.cg(tA, torch.from_numpy(b), torch.zeros(30))


def test_solve_linear_rejects_nonlinear_residual():
    with pytest.raises(ValueError, match="not affine"):
        linear.solve_linear(lambda u: u**2 - 1.0, (8, 8), device="cpu")
    with pytest.raises(ValueError, match="assemble='stencil'"):
        linear.solve_linear(lambda u: u, (8, 8), stencil_kernel="cuda",
                            device="cpu")
    with pytest.raises(ValueError, match="restart"):
        linear.solve_linear(lambda u: u, (8, 8), restart=5, device="cpu")
    # a mixed system's template (a dict of fields) is checked the same way
    with pytest.raises(ValueError, match="not affine"):
        linear.solve_linear(lambda f: {k: a**2 - 1.0 for k, a in f.items()},
                            {"u": torch.zeros(8, 8)}, device="cpu")


# ------------------------------------------------ module_linear_solve ----

def _exact(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y)


def _forcing(x, y):
    return 2 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y)


def _mms_pair(n, **kw):
    out = []
    for P, F, D in ((JPoisson2D, JRectangleManufactured, JDirectField),
                    (Poisson2D, RectangleManufactured, DirectField)):
        ds = F(n)
        ds.n_samples = 1
        out.append(P(D((n, n)), ds, domain_size=n, batch_size=1,
                     loss_type="resmin", exact_solution=_exact,
                     forcing=_forcing, mms_dirichlet=True, **kw))
    return out


def test_module_linear_solve_mms_65():
    jm, tm = _mms_pair(65)
    u_t, _ = linear.module_linear_solve(tm, tol=1e-10, device="cpu")
    u_j, _ = jlin.module_linear_solve(jm, tol=1e-10)
    rel_t = float(np.divide(*[float(v) for v in tm.calc_l2_err(
        torch.from_numpy(u_t))[::2]]))
    rel_j = float(np.divide(*[float(v) for v in jm.calc_l2_err(u_j)[::2]]))
    assert rel_t < 3e-4, (rel_t, rel_j)
    # both CG runs stop at the float32 floor, summed in other orders
    assert abs(rel_t - rel_j) < 1e-2 * rel_j, (rel_t, rel_j)
    np.testing.assert_allclose(u_t, np.asarray(u_j), atol=2e-5)


def test_module_linear_solve_without_forcing_tensor():
    """The MMS module carries its forcing as ``f_gp``, so the JAX package
    solves with ``forcing_tensor=None``; the port's ``residual_for_field``
    used to squeeze the None before it looked at ``f_gp`` and failed."""
    jm, tm = _mms_pair(17)
    inputs = tm.dataset[0][0]
    u_t, _ = linear.module_linear_solve(tm, inputs, None, tol=1e-10,
                                        device="cpu")
    u_j, _ = jlin.module_linear_solve(jm, inputs, None, tol=1e-10)
    np.testing.assert_allclose(u_t, np.asarray(u_j), atol=1e-5)


def test_module_linear_solve_source_sink_33():
    """tests/test_linear_solve.py's source (u = 1) / sink (u = 0) problem:
    the port's CG solution equals the JAX one."""
    n = 33
    ms = []
    for P, R, D in ((JPoisson2D, JRectangle, JDirectField),
                    (Poisson2D, Rectangle, DirectField)):
        ds = R(domain_size=n)
        ds.n_samples = 1
        ms.append(P(D((n, n)), ds, domain_size=n, batch_size=1,
                    loss_type="resmin"))
    u_j, _ = jlin.module_linear_solve(ms[0], tol=1e-10)
    u_t, _ = linear.module_linear_solve(ms[1], tol=1e-10, device="cpu")
    np.testing.assert_allclose(u_t[0], 1.0, atol=1e-5)
    np.testing.assert_allclose(u_t[-1], 0.0, atol=1e-5)
    np.testing.assert_allclose(u_t, np.asarray(u_j), atol=1e-5)
    # the stencil-assembled solve, through K4's wrapper (plain on the CPU)
    u_s, _ = linear.module_linear_solve(ms[1], tol=1e-10, assemble="stencil",
                                        stencil_kernel="cuda", device="cpu")
    np.testing.assert_allclose(u_s, np.asarray(u_j), atol=1e-5)


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_module_linear_solve_other_methods(method):
    jm, tm = _mms_pair(17)
    kw = {"tol": 1e-6, "maxiter": 8 if method == "gmres" else 200}
    u_t, _ = linear.module_linear_solve(tm, method=method, device="cpu", **kw)
    u_j, _ = jlin.module_linear_solve(jm, method=method, **kw)
    np.testing.assert_allclose(u_t, np.asarray(u_j), atol=1e-5)


def test_stokes_route_waits_for_the_flow_slice():
    """The flow slice is ported: Stokes modules route to
    stokes_linear_solve, and scalar-path knobs raise instead of being
    ignored (the solve itself: tests/test_torch_flow.py)."""
    class Stokes:
        eq_type = "stokes"

    for kw in ({"method": "gmres"}, {"M": lambda r: r},
               {"assemble": "stencil"}, {"forcing_tensor": np.zeros(1)}):
        with pytest.raises(ValueError, match="stokes_linear_solve"):
            linear.module_linear_solve(Stokes(), device="cpu", **kw)


# ------------------------------------------------------ transfers ----

@pytest.mark.parametrize("coarse,fine", [
    ((5, 5), (9, 9)), ((2, 5, 9), (9, 17)), ((5, 7), (9, 11)),
    ((3, 5, 5), (5, 9, 9)), ((2, 3, 3, 5), (5, 5, 9))])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_prolong_field_matches_jax(coarse, fine, method):
    """Orders 1 and 0 in 2D and 3D, with leading axes; order 0 at a 2x
    refinement sits on exact .5 coordinates at every odd node."""
    c = np.random.default_rng(8).random(coarse).astype(np.float32)
    got = continuation.prolong_field(torch.from_numpy(c), fine, method)
    want = jcont.prolong_field(jnp.asarray(c), fine, method)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unsupported"):
        continuation.prolong_field(torch.from_numpy(c), fine, "cubic")


def test_full_weight_halve_and_colored_diag_match_jax():
    a = np.random.default_rng(9).random((2, 17, 33)).astype(np.float32)
    np.testing.assert_array_equal(linear._full_weight_halve(a, 2),
                                  jlin._full_weight_halve(a, 2))
    jm, tm = _mms_pair(17)
    inputs = tm.dataset[0][0].copy()
    inputs[..., 0] = np.exp(np.random.default_rng(1).standard_normal(
        (17, 17))).astype(np.float32)
    ji, ti = jnp.asarray(inputs)[None], torch.from_numpy(inputs)[None]
    jb = jm.residual_for_field(jnp.zeros((1, 17, 17)), ji, None)
    tb = tm.residual_for_field(torch.zeros(1, 17, 17), ti, None)
    d_j = jlin._colored_diag(
        lambda u: jm.residual_for_field(u[None], ji, None)[0] - jb[0], 17, 2)
    d_t = linear._colored_diag(
        lambda u: tm.residual_for_field(u[None], ti, None)[0] - tb[0], 17, 2)
    _close(d_t, d_j, rtol=1e-5)


def test_coarse_to_fine_trains_each_grid_from_the_last():
    def factory(n):
        ds = RectangleManufactured(n)
        ds.n_samples = 1
        m = Poisson2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                      domain_size=n, batch_size=1, loss_type="resmin",
                      exact_solution=_exact, forcing=_forcing,
                      mms_dirichlet=True)
        return m, m.network

    m, state = continuation.coarse_to_fine(factory, [9, 17], [15, 3],
                                           device="cpu")
    assert tuple(state.params["field"].shape) == (17, 17)
    with torch.no_grad():
        u = m.network()[0]
        eL2, _, uex = m.calc_l2_err(u)
    assert tuple(u.shape) == (17, 17)
    assert float(eL2 / uex) < 2e-2


# ------------------------------------------------------- multigrid ----

class _VarNuDS:
    """One instance with a prescribed nu, source left / sink right, zero
    forcing (as tests/test_linear_solve.py)."""

    def __init__(self, nu):
        ny, nx = nu.shape
        bc1 = np.zeros((ny, nx)); bc1[:, 0] = 1
        bc2 = np.zeros((ny, nx)); bc2[:, -1] = 1
        self.inputs = np.stack([nu, bc1, bc2], -1).astype(np.float32)
        self.forcing = np.zeros((ny, nx, 1), np.float32)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def _bench_nu(ny, nx):
    """bench.py's smooth ~54x-contrast coefficient exp(2g)."""
    X, Y = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny),
                       indexing="xy")
    g = (np.cos(2 * np.pi * X) * np.cos(np.pi * Y)
         + 0.5 * np.sin(3 * np.pi * X * Y))
    return np.exp(2.0 * g / np.abs(g).max()).astype(np.float32)


def _factories(fine_shape, **kw):
    """JAX and port Poisson2D factories whose fine level owns the bench nu
    and whose coarser levels carry unit nu (so 'restrict' must feed them)."""
    ny, nx = fine_shape
    ds_fine = _VarNuDS(_bench_nu(ny, nx))

    def make(P, D):
        cache = {}

        def factory(n):
            shape = (n, n) if np.isscalar(n) else tuple(n)
            if shape not in cache:
                ds = ds_fine if shape == (ny, nx) else _VarNuDS(
                    np.ones(shape, np.float32))
                cache[shape] = P(D(shape), ds, domain_sizes=shape[::-1],
                                 batch_size=1, loss_type="resmin", **kw)
            return cache[shape]
        return factory

    return (make(JPoisson2D, JDirectField), make(Poisson2D, DirectField),
            ds_fine)


def _rhs(shape, seed=0):
    b = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    b[:, [0, -1]] = 0.0
    return b


MG_CASES = {   # name -> (port options, JAX options where they differ)
    "cheb-restrict-stencil": (dict(), None),
    "cuda-kernel-knob": (dict(stencil_kernel="cuda"), dict()),
    "jacobi": (dict(smoother="jacobi", n_smooth=2), None),
    "galerkin": (dict(coarse_op="galerkin", cheb_alpha=3.0), None),
    "galerkin-matrix-free": (dict(coarse_op="galerkin", assemble=None),
                             None),
    "stencil_coarse": (dict(assemble="stencil_coarse"), None),
    "own-datasets": (dict(inputs_per_level=None), None),
    "rectangular": (dict(n_fine=(17, 33)), None),
}
_JAX_MG = {}


def _jax_mg(kw, b):
    """levels, smoother, step sizes and M(b) of the JAX preconditioner with
    options `kw` (built once per option set: its setup compiles)."""
    key = repr(sorted(kw.items()))
    if key not in _JAX_MG:
        kw = dict(kw)
        n_fine = kw.pop("n_fine")
        shape = (n_fine, n_fine) if np.isscalar(n_fine) else n_fine
        jf, _, _ = _factories(shape)
        M, info = jlin.multigrid_preconditioner(jf, n_fine, **kw)
        _JAX_MG[key] = (info, np.asarray(M(jnp.asarray(b))))
    return _JAX_MG[key]


@pytest.mark.parametrize("case", list(MG_CASES))
def test_multigrid_preconditioner_matches_jax(case):
    """Levels, step sizes and one V-cycle M(b) of the port against JAX's,
    at 17² with the bench's 54x-contrast nu (levels 17², 9², 5²). The
    ``stencil_kernel`` knob changes where the apply runs, not what it
    computes, so it is held to the JAX preconditioner without it."""
    base = dict(n_fine=17, n_coarse=5, inputs_per_level="restrict")
    port_kw, jax_kw = MG_CASES[case]
    port_kw = dict(base, **port_kw)
    jax_kw = dict(port_kw) if jax_kw is None else dict(base, **jax_kw)
    n_fine = port_kw.pop("n_fine")
    shape = (n_fine, n_fine) if np.isscalar(n_fine) else n_fine
    b = _rhs(shape)
    info_j, Mb_j = _jax_mg(jax_kw, b)
    _, tf, _ = _factories(shape)
    Mt, info_t = linear.multigrid_preconditioner(tf, n_fine, device="cpu",
                                                 **port_kw)
    assert info_t["levels"] == info_j["levels"]
    assert info_t["smoother"] == info_j["smoother"]
    _close(info_t["omegas"], info_j["omegas"])
    _close(Mt(torch.from_numpy(b)), Mb_j)


def test_multigrid_fine_matvec_through_k1():
    """fine_matvec: the run-time fine operator of a module on the K1 path
    (its plain version here) gives the V-cycle of the element path."""
    n = 17
    _, tf, ds = _factories((n, n))
    _, tfk, _ = _factories((n, n), fused_kernels=True)
    mk = tfk(n)
    ti = torch.from_numpy(ds.inputs)[None]
    tfz = torch.from_numpy(ds.forcing)[None]
    b0 = mk.residual_for_field(torch.zeros(1, n, n), ti, tfz)

    def Ak(v):
        return mk.residual_for_field(v[None], ti, tfz)[0] - b0[0]

    Mk, _ = linear.multigrid_preconditioner(
        tf, n, n_coarse=5, inputs_per_level="restrict", fine_matvec=Ak,
        stencil_kernel="cuda", device="cpu")
    b = _rhs((n, n))
    _, Mb_j = _jax_mg(dict(n_fine=n, n_coarse=5, inputs_per_level="restrict"),
                      b)
    _close(Mk(torch.from_numpy(b)), Mb_j)


def test_multigrid_rejects_bad_options():
    _, tf, _ = _factories((9, 9))
    for kw, match in (({"smoother": "sor"}, "smoother"),
                      ({"assemble": "dense"}, "assemble"),
                      ({"assemble": None, "stencil_kernel": "cuda"},
                       "assembling"),
                      ({"cheb_alpha": 1.0}, "cheb_alpha")):
        with pytest.raises(ValueError, match=match):
            linear.multigrid_preconditioner(tf, 9, device="cpu", **kw)


def test_mgcg_65_bench_nu_relres_within_2x_of_jax():
    """bench.py's 54x-contrast MG-CG at 65² (n_coarse=33: levels 65, 33),
    10 iterations: the port's relative residual within 2x of JAX's."""
    n = 65
    jf, tf, ds = _factories((n, n))
    b = _rhs((n, n))
    rel = {}
    for name, mglib, m, asarr, norm, dev in (
            ("jax", jlin, jf(n), jnp.asarray, jnp.linalg.norm, {}),
            ("torch", linear, tf(n), torch.from_numpy, torch.linalg.norm,
             {"device": "cpu"})):
        M, _ = mglib.multigrid_preconditioner(
            jf if name == "jax" else tf, n, n_coarse=33,
            inputs_per_level="restrict", **dev)
        inputs, forcing = asarr(ds.inputs)[None], asarr(ds.forcing)[None]
        bb = asarr(b)

        def resfn(u, m=m, inputs=inputs, forcing=forcing, bb=bb):
            return m.residual_for_field(u[None], inputs, forcing)[0] - bb

        u, _ = mglib.solve_linear(resfn, (n, n), tol=0.0, maxiter=10, M=M,
                                  **dev)
        rel[name] = float(norm(resfn(u)) / norm(bb))
    assert rel["jax"] < 1e-4, rel
    assert rel["torch"] < 2 * rel["jax"], rel


# ------------------------------------------------------------- ILU ----

def _laplacian(n):
    T = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    return (np.kron(T, np.eye(n)) + np.kron(np.eye(n), T)).astype(np.float32)


def test_ilu_from_operator_and_load_match_jax(tmp_path):
    A = _laplacian(5) + 0.1 * np.random.default_rng(10).random(
        (25, 25)).astype(np.float32)

    def matvec(v):
        return A @ v

    got = precond.ilu_from_operator(matvec, 25)
    np.testing.assert_array_equal(got, jprecond.ilu_from_operator(matvec, 25))
    scipy.io.savemat(tmp_path / "dense.mat", {"invL": got})
    np.testing.assert_array_equal(
        precond.load_ilu_mat(tmp_path / "dense.mat"),
        jprecond.load_ilu_mat(tmp_path / "dense.mat"))
    r, c = np.nonzero(got)
    scipy.io.savemat(tmp_path / "coo.mat", {
        "rows": (r + 1).astype(np.float64), "cols": (c + 1).astype(np.float64),
        "data": got[r, c].astype(np.float64)})
    loaded = precond.load_ilu_mat(tmp_path / "coo.mat")
    np.testing.assert_array_equal(loaded,
                                  jprecond.load_ilu_mat(tmp_path / "coo.mat"))
    np.testing.assert_allclose(loaded, got, rtol=1e-6)
