"""The port's split solvers (the split stencil matvec ``SplitStencil``,
``assemble_stencil``, ``solve_linear`` and ``multigrid_preconditioner``
with ``mesh=``, split GMRES) and its uneven
row blocks, against the JAX package's spatially sharded tests'
(tests/test_parallel.py:229-337) unsharded answers and the port's own
single process.

One module-scoped spawn of 4 gloo ranks on the CPU
(tests/torch_solver_ranks.py::solvers_rank) computes each rank's rows; the
tests stack them. The JAX package's tests pin its sharded runs to these
unsharded ones on its 8-device mesh.

Tolerances: the stencil matvec at atol 1e-5 and its CG solves at 2e-4, as
JAX's test holds its sharded ones; the V-cycle within 2e-6 x max |M v| and
8 MG-CG iterations at atol 2e-5, as JAX's; the split stencil planes exact
(each probe's rows are the unsplit probe's). Split GMRES against one
process within 1e-4 x max |x|: its least-squares step through the normal
equations turns the rounding of the split inner products into ~5e-5 of
max |x| after two restart cycles (the one-process float32 iterate itself
lies 4.9e-5 of max |x| from its float64 run).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from diffnet_tpu.core import fem as jfem
from diffnet_tpu.core.quadrature import make_basis as jmake_basis
from diffnet_tpu.data.single_instances import (
    RectangleManufactured as JRectangleManufactured)
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde import Poisson2D as JPoisson2D
from diffnet_tpu.train import multigrid_preconditioner as jmultigrid
from diffnet_tpu.train.linear import solve_linear as jsolve_linear
from diffnet_tpu.train.stencil import assemble_stencil as jassemble_stencil
from diffnet_tpu_torch.parallel import block_bounds, run_ranks
from tests import torch_solver_ranks as ranks

WORLD = 4
ROUND_TRIP = (64, 65, 17, 10)   # equal blocks, then uneven ones


def _walls(n):
    bc = np.zeros((n, n), np.float32)
    bc[[0, -1], :] = 1
    bc[:, [0, -1]] = 1
    return bc


def _payload():
    # tests/test_parallel.py:229-278's draws, in its order
    n = 64
    rng = np.random.default_rng(7)
    bc = _walls(n)
    b = np.where(bc > 0.5, 0.0, rng.standard_normal((n, n))
                 ).astype(np.float32)
    nu = (1.0 + rng.random((n, n))).astype(np.float32)
    probe = rng.standard_normal((n, n)).astype(np.float32)
    # tests/test_parallel.py:280-337's
    m = 65
    rng = np.random.default_rng(0)
    v = rng.standard_normal((m, m)).astype(np.float32)
    bm = np.where(_walls(m) > 0.5, 0.0, rng.standard_normal((m, m))
                  ).astype(np.float32)
    return {"round_trip": ROUND_TRIP,
            "stencil": {"b": b, "nu": nu, "bc": bc, "probe": probe},
            "mg": {"v": v, "b": bm}}


def _stack(out, key):
    return np.concatenate([o[key] for o in out], axis=0)


def _jax_stencil(p):
    """JAX's unsharded stencil, matvec and CG solve of the 64^2 case."""
    s = p["stencil"]
    n = s["b"].shape[0]
    jb = jmake_basis(2, 1, h=(1 / (n - 1),) * 2)
    nu, bc, b = (jnp.asarray(s[k]) for k in ("nu", "bc", "b"))

    def resfn(u):
        gp = jfem.gp_eval(u[None], jb, ("dx", "dy"))
        nu_gp = jfem.gp_eval(nu[None], jb, ("N",))["N"]
        R = jfem.galerkin_project_multi(
            [(nu_gp * gp["dx"], "dx"), (nu_gp * gp["dy"], "dy")], jb,
            (n, n))[0]
        return jnp.where(bc > 0.5, 0.0, R) - b

    matvec, rhs, C = jassemble_stencil(resfn, (n, n))
    u, _ = jsolve_linear(lambda u: matvec(u) - rhs, (n, n), tol=1e-8,
                         maxiter=200)
    return {"C": np.asarray(C), "mv": np.asarray(matvec(
        jnp.asarray(s["probe"]))), "solve": np.asarray(u)}


def _jax_mg(p):
    """JAX's V-cycle M(v) and 8 MG-CG iterations on the 65^2 MMS case."""
    g = p["mg"]
    n = g["v"].shape[0]

    def factory(m_n):
        ds = JRectangleManufactured(domain_size=m_n)
        ds.n_samples = 1
        return JPoisson2D(JDirectField((m_n, m_n)), ds, domain_size=m_n,
                          batch_size=1, loss_type="resmin")

    M, _ = jmultigrid(factory, n)
    m = factory(n)
    inputs = jnp.asarray(m.dataset[0][0])[None]
    forcing = jnp.zeros((1, n, n, 1), jnp.float32)
    b = jnp.asarray(g["b"])

    def resfn(u):
        return m.residual_for_field(u[None], inputs, forcing)[0] - b

    u, _ = jsolve_linear(resfn, (n, n), tol=1e-12, maxiter=8, M=M)
    return {"Mv": np.asarray(M(jnp.asarray(g["v"]))), "cg": np.asarray(u)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' blocks and the JAX references: the ranks run in their own
    processes while JAX computes here (its multigrid setup alone takes
    ~15 s on a CPU)."""
    p = _payload()
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, ranks.solvers_rank, WORLD, (p,),
                              init_method=init, timeout=120.0, threads=1)
        refs = {"stencil": _jax_stencil(p), "mg": _jax_mg(p)}
        out = spawned.result()
    return p, out, refs


@pytest.fixture(scope="module")
def run(results):
    return results[:2]


@pytest.fixture(scope="module")
def jax_stencil(results):
    return results[2]["stencil"]


@pytest.fixture(scope="module")
def jax_mg(results):
    return results[2]["mg"]


@pytest.mark.parametrize("n", ROUND_TRIP)
def test_uneven_blocks_round_trip(run, n):
    """local_block's rows follow block_bounds (equal blocks where the rows
    divide, as before; else (n - 1) / 4 rows and the rest in the last), and
    gather_block puts them back, with the global length given or not."""
    p, out = run
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    b = block_bounds(n, WORLD)
    if n % WORLD == 0:
        assert b == [j * n // WORLD for j in range(WORLD + 1)]
    else:
        assert b[1:-1] == [j * ((n - 1) // WORLD) for j in range(1, WORLD)]
    for s, o in enumerate(out):
        blk, got_n, got = o["round_trip", n]
        np.testing.assert_array_equal(blk, x[b[s]:b[s + 1]])
        np.testing.assert_array_equal(got_n, x)
        np.testing.assert_array_equal(got, x)


def test_block_bounds_halve_down_a_hierarchy():
    """The splits of a 2^p + 1 level fall at half the level above's, so a
    prolongation needs one coarse halo row; too few rows raise."""
    for n in (513, 257, 129, 65, 33):
        assert block_bounds(2 * n - 1, WORLD)[1:-1] == [
            2 * a for a in block_bounds(n, WORLD)[1:-1]]
    with pytest.raises(ValueError):
        block_bounds(3, WORLD)


def test_split_stencil_matches_jax(run, jax_stencil):
    """The stencil planes extracted through the split residual (each rank
    its rows) and the split matvec of a probe, against JAX's unsharded
    ones (JAX pins its sharded matvec to them at atol 1e-5)."""
    _, out = run
    np.testing.assert_allclose(
        np.concatenate([o["stencil_C"] for o in out], axis=1),
        jax_stencil["C"], rtol=0,
        atol=2e-6 * np.abs(jax_stencil["C"]).max())
    np.testing.assert_allclose(_stack(out, "stencil_mv"), jax_stencil["mv"],
                               atol=1e-5)


@pytest.mark.parametrize("route", ["stencil_cg", "stencil_solve"])
def test_split_stencil_cg_matches_jax(run, jax_stencil, route):
    """CG over the split stencil (assemble_stencil's matvec, and
    solve_linear(assemble='stencil', stencil_kernel='cuda') on its own)
    against JAX's solve, as JAX holds its sharded one."""
    _, out = run
    np.testing.assert_allclose(_stack(out, route), jax_stencil["solve"],
                               atol=2e-4)


def test_split_vcycle_matches_jax(run, jax_mg):
    """M(v) over 4 uneven row blocks (65 = 16 + 16 + 16 + 17 rows; 33 and
    17 split too, 9 gathered) against JAX's V-cycle."""
    _, out = run
    assert all(o["mg_split_levels"] == 3 for o in out)
    want = jax_mg["Mv"]
    np.testing.assert_allclose(_stack(out, "mg_Mv"), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_split_mgcg_matches_jax(run, jax_mg):
    """8 MG-CG iterations over the split stencil and V-cycle against
    JAX's."""
    _, out = run
    np.testing.assert_allclose(_stack(out, "mg_cg"), jax_mg["cg"],
                               atol=2e-5)


def test_split_gmres_matches_one_process(run):
    """Two restart cycles of split GMRES on the 64^2 Poisson residual (the
    Arnoldi projections and norms all-reduced) against one process."""
    p, out = run
    want = ranks.poisson_gmres_one_process(p["stencil"])
    np.testing.assert_allclose(_stack(out, "gmres_poisson"), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
