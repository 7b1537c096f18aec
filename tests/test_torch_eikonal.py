"""The port's eikonal SDF path against the JAX package's, on the same numpy
inputs: grid interpolation, the signed occupancy start, the 2D, 3D and FDM
eikonal losses, the Gauss-Newton residual and ``gauss_newton_solve``, a
short training run, and the device guard of the new entry points.

Tolerances: in float64 (JAX under ``enable_x64``) values, losses and
gradients within 1e-10 of the largest |JAX value|; in float32 within 1e-5
relative (of the largest |value| for arrays); the signed start equal at
every node (no node of these clouds lies within 1e-4 of w = 0.5); the
Gauss-Newton step on the 24^2 circle accepted alike, its loss history and
field within 1e-10 in float64, and in float32 the history within 1e-5
relative and the field within 1e-5 (measured 4.3e-6 and 2.1e-6); Adam
losses within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.core import interp as jinterp
from diffnet_tpu.data.loader import InMemoryDataset as JInMemoryDataset
from diffnet_tpu.data.loader import NumpyLoader as JNumpyLoader
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde import eikonal as jeik
from diffnet_tpu.train.linear import gauss_newton_solve as jgauss_newton
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.core import geometry as tgeo
from diffnet_tpu_torch.core import interp as tinterp
from diffnet_tpu_torch.data import InMemoryDataset, NumpyLoader
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.pde import (Eikonal2D, Eikonal3D, EikonalFDM2D,
                                   eikonal_gn_residual,
                                   signed_occupancy_init)
from diffnet_tpu_torch.train import Callback, Trainer, gauss_newton_solve
from diffnet_tpu_torch.train.linear import _normal_equations

F64_TOL = 1e-10
F32_RTOL = 1e-5
GN_LOSS_RTOL = 1e-5
GN_FIELD_ATOL = 1e-5


def _close(got, want, dtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    tol = F64_TOL if dtype == "float64" else F32_RTOL
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# -- interpolation ------------------------------------------------------------

def _points(nsd, n, deg, rng):
    """Random interior points, points on element edges (i * h in float32),
    on the far boundary, and outside the grid, [1, Np, nsd] float32."""
    h = np.float32(deg / (n - 1))
    inner = rng.uniform(0, 1, (20, nsd))
    edge = rng.integers(0, (n - 1) // deg + 1, (10, nsd)) * h
    far = np.ones((3, nsd))
    far[1, 0], far[2, -1] = 0.3, 0.0
    out = rng.uniform(-0.2, 1.2, (8, nsd))
    out[:4, 0] = [-0.15, 1.1, -0.01, 1.01]
    return np.concatenate([inner, edge, far, out]).astype(np.float32)[None]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nsd,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_interp_values_and_gradients_match_jax(nsd, deg, dtype):
    """Values and gradients at points inside, on element edges, on the far
    boundary and outside; and the gradients of a functional of both in u
    and in the points."""
    rng = np.random.default_rng(10 * nsd + deg)
    n = 9 if nsd == 3 else 17
    shape = (2,) + (n,) * nsd
    np_dtype = np.float64 if dtype == "float64" else np.float32
    u = rng.standard_normal(shape).astype(np_dtype)
    pts = np.repeat(_points(nsd, n, deg, rng), 2, 0).astype(np_dtype)
    w = rng.standard_normal(pts.shape[:2] + (nsd + 1,)).astype(np_dtype)
    hs = (1.0 / (n - 1),) * nsd
    jfn = jinterp.grid_interp_2d if nsd == 2 else jinterp.grid_interp_3d
    tfn = tinterp.grid_interp_2d if nsd == 2 else tinterp.grid_interp_3d

    def jf(v, p):
        vals, grads = jfn(v, p, hs, deg=deg)
        return jnp.sum(vals * w[..., 0]) + jnp.sum(grads * w[..., 1:]), \
            (vals, grads)

    with jax.enable_x64(dtype == "float64"):
        (_, (jv, jg)), (jdu, jdp) = jax.jit(jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True))(jnp.asarray(u),
                                               jnp.asarray(pts))
    tu = torch.from_numpy(u).requires_grad_()
    tp = torch.from_numpy(pts).requires_grad_()
    tv, tg = tfn(tu, tp, hs, deg=deg)
    assert tv.shape == jv.shape and tg.shape == jg.shape
    (torch.sum(tv * torch.from_numpy(w[..., 0]))
     + torch.sum(tg * torch.from_numpy(w[..., 1:]))).backward()
    for got, want in ((tv, jv), (tg, jg), (tu.grad, jdu), (tp.grad, jdp)):
        _close(got, want, dtype)


def test_interp_locates_points_as_jax_does():
    """Float32 points on element edges land in the element JAX picks: the
    gradient, discontinuous across the edge, is equal there; the far
    boundary and outside points clip to the last or first element."""
    n = 17
    h = 1.0 / (n - 1)
    x = (np.arange(n, dtype=np.float32) * np.float32(h))
    pts = np.stack([x, np.full(n, 0.3, np.float32)], -1)[None]
    u = (np.random.default_rng(0).standard_normal((1, n, n))
         .astype(np.float32))
    _, jg = jax.jit(lambda v, p: jinterp.grid_interp_2d(v, p, (h, h)))(
        jnp.asarray(u), jnp.asarray(pts))
    _, tg = tinterp.grid_interp_2d(torch.from_numpy(u),
                                   torch.from_numpy(pts), (h, h))
    # another element would change the gradient by O(1), not by rounding
    _close(tg, jg, "float32")


def test_interp_rejects_grids_the_degree_does_not_divide():
    for fn in (tinterp.grid_interp_2d, jinterp.grid_interp_2d):
        with pytest.raises(ValueError, match="incompatible with deg=2"):
            fn(np.zeros((1, 10, 9), np.float32) if fn is
               jinterp.grid_interp_2d else torch.zeros(1, 10, 9),
               np.zeros((1, 1, 2), np.float32) if fn is
               jinterp.grid_interp_2d else torch.zeros(1, 1, 2),
               (0.1, 0.1), deg=2)


def test_poly_coeffs_match_jax():
    for deg in (1, 2, 3):
        for a, b in zip(tinterp._poly_coeffs(deg), jinterp._poly_coeffs(deg)):
            assert np.array_equal(a, b)


# -- the signed start ---------------------------------------------------------

def _ellipse(n_points=100, radii=(0.25, 0.25)):
    pts, nrm, area = tgeo.sample_ellipse_cloud(n_points=n_points,
                                               center=(0.5, 0.5), radii=radii)
    return pts, nrm, area


def test_signed_occupancy_init_matches_jax():
    for args, shape in ((_ellipse(), (24, 24)),
                        (tgeo.sample_sphere_cloud(n_points=400), (9, 9, 9))):
        want = np.asarray(jeik.signed_occupancy_init(
            *(jnp.asarray(a)[None] for a in args), shape))
        got = signed_occupancy_init(*(torch.from_numpy(a)[None]
                                      for a in args), shape)
        assert got.shape == (1,) + shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert set(np.unique(want)) == {np.float32(-0.1), np.float32(0.1)}


# -- losses -------------------------------------------------------------------

def _cloud(nsd, n_points):
    if nsd == 2:
        pts, nrm, area = _ellipse(n_points, radii=(0.28, 0.18))
    else:
        pts, nrm, area = tgeo.sample_sphere_cloud(n_points=n_points)
    return np.concatenate([pts, nrm, area[:, None]], -1)[None]


def _eikonal_pair(kind, n, deg=1):
    cls = {"2d": (jeik.Eikonal2D, Eikonal2D),
           "3d": (jeik.Eikonal3D, Eikonal3D),
           "fdm": (jeik.EikonalFDM2D, EikonalFDM2D)}[kind]
    return [c(None, None, domain_size=n, batch_size=1, sdf_weight=100.0,
              normals_weight=10.0, fem_basis_deg=deg) for c in cls]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind,deg", [("2d", 1), ("2d", 2), ("3d", 1),
                                      ("fdm", 1)])
def test_eikonal_loss_and_gradient_match_jax(kind, deg, dtype):
    """Each loss and its gradient in the field at a seeded random field
    (17^2; 9^3 in 3D); the cloud stays float32, as a dataset gives it."""
    n = 9 if kind == "3d" else 17
    nsd = 3 if kind == "3d" else 2
    jm, tm = _eikonal_pair(kind, n, deg)
    cloud = np.repeat(_cloud(nsd, 60), 2, 0).astype(np.float32)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    u = np.random.default_rng(7).standard_normal((2,) + (n,) * nsd).astype(
        np_dtype) * 0.3
    forcing = np.zeros((2,) + (n,) * nsd + (1,), np_dtype)
    with jax.enable_x64(dtype == "float64"):
        jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
            *map(jnp.asarray, (u, cloud, forcing)))
    tu = torch.from_numpy(u).requires_grad_()
    tl = tm.loss(tu, torch.from_numpy(cloud), torch.from_numpy(forcing))
    tl.backward()
    assert tl.dtype == tu.dtype
    _close(tl, jl, dtype)
    _close(tu.grad, jg, dtype)


def test_fdm_variant_rejects_non_unit_domains():
    for cls in (jeik.EikonalFDM2D, EikonalFDM2D):
        with pytest.raises(ValueError, match="square unit domains"):
            cls(None, None, domain_sizes=(17, 9))
        with pytest.raises(ValueError, match="square unit domains"):
            cls(None, None, domain_size=17, domain_lengths=(2.0, 1.0))


@pytest.mark.parametrize("nsd", [2, 3])
def test_gn_residual_matches_jax(nsd):
    """The three least-squares blocks at a random field, float64."""
    n = 9 if nsd == 3 else 17
    jm, tm = _eikonal_pair("3d" if nsd == 3 else "2d", n)
    cloud = _cloud(nsd, 60).astype(np.float32)
    u = np.random.default_rng(8).standard_normal((n,) * nsd) * 0.3
    with jax.enable_x64(True):
        want = jax.jit(jeik.eikonal_gn_residual(jm, cloud))(jnp.asarray(u))
    got = eikonal_gn_residual(tm, cloud, device="cpu")(torch.from_numpy(u))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], "float64")


def _circle(n):
    """The JAX package's Gauss-Newton circle: cloud, both modules and the
    signed start."""
    pts, nrm, area = _ellipse()
    cloud = np.concatenate([pts, nrm, area[:, None]], -1)[None]
    kw = dict(domain_size=n, batch_size=1, sdf_weight=100.0,
              normals_weight=10.0)
    u0 = np.asarray(jeik.signed_occupancy_init(
        *(jnp.asarray(a)[None] for a in (pts, nrm, area)), (n, n)))[0]
    return (cloud, jeik.Eikonal2D(None, None, **kw),
            Eikonal2D(None, None, **kw), u0)


def test_gauss_newton_operators_match_jax():
    """J^T r and (J^T J) v of the circle's residual at a random field, the
    port's (J v by the double-VJP identity) against JAX's vjp and jvp,
    float64; and the identity against torch.func.jvp."""
    n = 17
    cloud, jm, tm, _ = _circle(n)
    rng = np.random.default_rng(9)
    u, v = (rng.standard_normal((n, n)) * 0.3 for _ in range(2))
    jr, tr = (jeik.eikonal_gn_residual(jm, cloud),
              eikonal_gn_residual(tm, cloud, device="cpu"))
    with jax.enable_x64(True):
        def jops(u, v):
            r, vjp_fn = jax.vjp(jr, u)
            return vjp_fn(r)[0], vjp_fn(jax.jvp(jr, (u,), (v,))[1])[0]

        jg, jjtj = jax.jit(jops)(jnp.asarray(u), jnp.asarray(v))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    g, JTJ = _normal_equations(tr, tu)
    _close(g, jg, "float64")
    _close(JTJ(tv), jjtj, "float64")
    _, vjp_fn = torch.func.vjp(tr, tu)
    _close(JTJ(tv), vjp_fn(torch.func.jvp(tr, (tu,), (tv,))[1])[0],
           "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gauss_newton_step_follows_jax_on_the_circle(dtype):
    """The first Gauss-Newton step (100 CG iterations, lm 1e-4) on the
    24^2 circle: the same accepted step, the loss history and the field
    as JAX's (1e-10 in float64; in float32 the history within 1e-5
    relative, the field within 1e-5). Later steps part in both precisions:
    CG on this system (lm 1e-4) is not converged at 100 iterations and
    its rounding, or a stop one iteration apart, moves the next direction
    by ~1e-3 (JAX's own float32 and float64 runs take 18 and 10 steps)."""
    n = 24
    cloud, jm, tm, u0 = _circle(n)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    u0 = u0.astype(np_dtype)
    kw = dict(newton_iters=1, cg_iters=100, lm=1e-4)
    with jax.enable_x64(dtype == "float64"):
        jx, jinfo = jgauss_newton(jeik.eikonal_gn_residual(jm, cloud),
                                  jnp.asarray(u0), **kw)
        jx = np.asarray(jx)
    tx, tinfo = gauss_newton_solve(
        eikonal_gn_residual(tm, cloud, device="cpu"),
        torch.from_numpy(u0.copy()), device="cpu", **kw)
    assert tx.dtype == torch.from_numpy(u0).dtype
    assert sorted(tinfo) == sorted(jinfo)
    assert tinfo["gn_iters"] == jinfo["gn_iters"] == 1
    rtol = F64_TOL if dtype == "float64" else GN_LOSS_RTOL
    atol = F64_TOL if dtype == "float64" else GN_FIELD_ATOL
    np.testing.assert_allclose(tinfo["loss_history"], jinfo["loss_history"],
                               rtol=rtol)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=atol)


def test_gauss_newton_reconstructs_the_circle():
    """Two steps from the signed start already meet the JAX package's
    accuracy bar: mean |u - sdf| < 0.05 away from the corners."""
    n = 24
    cloud, _, tm, u0 = _circle(n)
    tx, info = gauss_newton_solve(
        eikonal_gn_residual(tm, cloud, device="cpu"), torch.tensor(u0),
        newton_iters=2, cg_iters=100, lm=1e-4, device="cpu")
    assert info["gn_iters"] == 2
    assert info["loss_history"][-1] < 1e-4 * info["loss_history"][0]
    xg = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(xg, xg)
    rr = np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2)
    err = np.abs(tx.numpy() - (rr - 0.25))[rr < 0.45]
    assert err.mean() < 0.05, err.mean()


def test_gauss_newton_solves_a_linear_least_squares_problem():
    """A plain tensor residual A x - b: Gauss-Newton lands on lstsq's
    answer in one step (float64)."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((12, 8)))
    b = torch.from_numpy(rng.standard_normal(12))
    x, info = gauss_newton_solve(lambda x: A @ x - b,
                                 torch.zeros(8, dtype=torch.float64),
                                 newton_iters=3, cg_iters=20, device="cpu")
    want = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-10)
    assert info["gn_iters"] >= 1
    assert info["loss_history"][-1] < info["loss_history"][0]


def test_new_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = Eikonal2D(None, None, domain_size=9)
    cloud = _cloud(2, 20).astype(np.float32)
    with pytest.raises(RuntimeError, match="gauss_newton_solve"):
        gauss_newton_solve(lambda x: x, torch.zeros(3))
    with pytest.raises(RuntimeError, match="eikonal_gn_residual"):
        eikonal_gn_residual(m, cloud)
    assert eikonal_gn_residual(m, cloud, device="cpu") is not None


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


def test_eikonal_adam_run_matches_jax_trainer():
    """4 Adam epochs on a cloud batch from the signed start, through each
    package's loader: losses step for step."""
    n = 17
    cloud = _cloud(2, 80).astype(np.float32)
    forcing = np.zeros((1, n, n, 1), np.float32)
    u0 = np.asarray(jeik.signed_occupancy_init(
        *(jnp.asarray(cloud[..., k]) for k in (slice(0, 2), slice(2, 4), 4)),
        (n, n)))[0]
    kw = dict(domain_size=n, batch_size=1, sdf_weight=100.0,
              normals_weight=10.0)
    jm = jeik.Eikonal2D(JDirectField((n, n), init=u0), None, **kw)
    tm = Eikonal2D(DirectField((n, n), init=u0), None, **kw)
    jcb, tcb = _JLosses(), _TLosses()
    JTrainer(max_epochs=4, optimizer="adam", learning_rate=1e-3,
             callbacks=[jcb]).fit(
        jm, JNumpyLoader(JInMemoryDataset(cloud, forcing), batch_size=1))
    Trainer(max_epochs=4, optimizer="adam", learning_rate=1e-3,
            callbacks=[tcb], device="cpu").fit(
        tm, NumpyLoader(InMemoryDataset(cloud, forcing), batch_size=1))
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=F32_RTOL)
    assert tcb.losses[-1] < tcb.losses[0]
