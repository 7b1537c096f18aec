"""The port's spatially sharded 2D Poisson stiffness actions and the Krylov
solve over a row-split field (diffnet_tpu_torch.parallel.spatial,
``solve_linear(mesh=)``) against the JAX package's explicit shard_map
versions on the 8-device virtual mesh (tests/conftest.py) with
``space=4``.

One module-scoped spawn of 4 gloo ranks on the CPU
(tests/torch_parallel_ranks.py::spatial_rank) computes each rank's rows;
the tests stack them. The JAX K1 path runs its Pallas kernel in interpret
mode (the monkeypatch of tests/test_torch_kernels.py).

Tolerances: fields at 2e-6 x max(1, max |ref|) (the kernel tests' own for
O(1) float32 stencils); the VJPs through the halo exchange against
autograd through the port's unsharded operator at the same tolerance; the
solves at atol 2e-4, as tests/test_parallel.py holds JAX's sharded solve
to its unsharded one.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.sharding import NamedSharding, PartitionSpec as P

from diffnet_tpu.core import fem as jfem
from diffnet_tpu.core.quadrature import make_basis as jmake_basis
from diffnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffnet_tpu.parallel.spatial import (
    poisson_residual_spatial as jresidual_spatial,
    poisson_stiffness_spatial_fused as jfused_spatial)
from diffnet_tpu.train.linear import solve_linear as jsolve_linear
from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.ops.poisson_residual import poisson_stiffness_action
from diffnet_tpu_torch.parallel import run_ranks
from diffnet_tpu_torch.train import solve_linear
from tests import torch_parallel_ranks as ranks

WORLD = 4
SIZES = (32, 64)
# the JAX package's own tests' sizes: the fused K1 path at 32^2
# (test_pallas_kernel.py), the plain element path at 64^2 (test_parallel.py)
JAX_CASES = (("k1", 32), ("plain", 64))


def _field_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * max(1.0, np.abs(want).max()))


def _walls(n):
    bc = np.zeros((n, n), np.float32)
    bc[[0, -1], :] = 1
    bc[:, [0, -1]] = 1
    return bc


def _payload():
    rng = np.random.default_rng(3)
    cases = {n: tuple(rng.random((2, n, n)).astype(np.float32)
                      for _ in range(3)) for n in SIZES}
    n = 64
    b = np.where(_walls(n) > 0.5, 0.0, rng.standard_normal((n, n))
                 ).astype(np.float32)
    return {"cases": cases, "cg_b": b, "cg_bc": _walls(n)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    p = _payload()
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    out = run_ranks(ranks.spatial_rank, WORLD, (p,), init_method=init,
                    timeout=120.0, threads=1)
    return p, {k: tuple(np.concatenate([o[k][i] for o in out], axis=-2)
                        for i in range(3))
               if k[0] in ("plain", "k1")
               else np.concatenate([o[k] for o in out], axis=0)
               for k in out[0]}


@pytest.fixture(scope="module")
def jax_refs(run):
    """JAX's spatial residual and fused K1 (Pallas in interpret mode) on a
    data=2 x space=4 mesh, and its sharded CG solve."""
    p, _ = run
    mesh = jmake_mesh(data=2, space=4)
    interp = partial(pl.pallas_call, interpret=True)
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interp)
        for name, n in JAX_CASES:
            u, nu, _ = p["cases"][n]
            jb = jmake_basis(2, 1, h=(1 / (n - 1),) * 2)
            fn = jfused_spatial if name == "k1" else jresidual_spatial
            with mesh:
                refs[name, n] = np.asarray(fn(jnp.asarray(u),
                                              jnp.asarray(nu), jb, mesh))
    n = 64
    jb = jmake_basis(2, 1, h=(1 / (n - 1),) * 2)
    jbc = jnp.asarray(p["cg_bc"])
    sh = NamedSharding(mesh, P("space", None))
    b = jax.device_put(jnp.asarray(p["cg_b"]), sh)

    def resfn(u):
        gp = jfem.gp_eval(u[None], jb, ("dx", "dy"))
        R = jfem.galerkin_project_multi(
            [(gp["dx"], "dx"), (gp["dy"], "dy")], jb, (n, n))[0]
        return jnp.where(jbc > 0.5, 0.0, R) - b

    with mesh:
        u, _ = jsolve_linear(resfn, (n, n), tol=1e-8, maxiter=200,
                             x0=jax.device_put(jnp.zeros((n, n)), sh))
    refs["solve"] = np.asarray(u)
    return refs


@pytest.mark.parametrize("name,n", JAX_CASES)
def test_spatial_stiffness_matches_jax(run, jax_refs, name, n):
    """poisson_residual_spatial (plain element path) and
    poisson_stiffness_spatial_fused (K1) over 4 row blocks against JAX's
    shard_map versions of the same names."""
    _, got = run
    _field_close(got[name, n][0], jax_refs[name, n])


@pytest.mark.parametrize("name", ["plain", "k1"])
@pytest.mark.parametrize("n", SIZES)
def test_spatial_vjps_through_the_halo_exchange(run, name, n):
    """The u and nu cotangents of <g, K(nu) u> over 4 ranks (the stiffness
    VJPs on the halo'd blocks, the exchange's backward returning the halo
    rows) against autograd through the port's unsharded K1."""
    p, got = run
    u, nu, g = (torch.tensor(a, requires_grad=True) for a in p["cases"][n])
    tb = fem.BasisTables(make_basis(2, 1, h=(1 / (n - 1),) * 2))
    R = poisson_stiffness_action(u, nu, tb)
    (R * g.detach()).sum().backward()
    _field_close(got[name, n][0], R.detach().numpy())
    _field_close(got[name, n][1], u.grad.numpy())
    _field_close(got[name, n][2], nu.grad.numpy())


def test_sharded_cg_solve_matches_jax(run, jax_refs):
    """CG at 64^2 over 4 row blocks, every matvec through spatial K1 and
    every inner product all-reduced, against JAX's spatially sharded CG
    solve (tests/test_parallel.py's case)."""
    _, got = run
    np.testing.assert_allclose(got["solve", "cg"], jax_refs["solve"],
                               atol=2e-4)


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_sharded_krylov_solve_matches_one_process(run, method):
    """Each Krylov method over 4 row blocks against the port's unsharded
    solve of the same problem (K1 on the whole field)."""
    p, got = run
    n = p["cg_b"].shape[-1]
    tb = fem.BasisTables(make_basis(2, 1, h=(1 / (n - 1),) * 2))
    b, bc = torch.tensor(p["cg_b"]), torch.tensor(p["cg_bc"])

    def resfn(u):
        K = poisson_stiffness_action(u[None], torch.ones_like(u)[None],
                                     tb)[0]
        return torch.where(bc > 0.5, torch.zeros_like(K), K) - b

    u, _ = solve_linear(resfn, (n, n), method=method, device="cpu",
                        **ranks.SOLVES[method])
    np.testing.assert_allclose(got["solve", method], u.numpy(), atol=2e-4)
