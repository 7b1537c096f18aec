"""The port's Navier-Stokes VMS residual over a ``data x space`` process
mesh (``calc_residuals`` / ``mixed_residual`` with ``mesh=``: row blocks
with one halo row, the plain path and K6's row-block entry), its VJP
through the halo exchange and the mean-control gauge's all-reduce, and
split GMRES on its Jacobian action, against the JAX package's
``calc_residuals`` (tests/test_parallel.py:153-181's case, which JAX pins
sharded = unsharded at atol 2e-5) and the port's own single process.

One module-scoped spawn of 4 gloo ranks on the CPU (data=2 x space=2;
tests/torch_solver_ranks.py::flow_rank) computes each rank's blocks; the
tests put them together. K6's entry runs its plain version on CPU tensors.

Tolerances: against JAX at atol 2e-5 (its own test's); against one process
2e-6 x max |ref|, the kernel tests' relative tolerance for float32 sums in
another order (the split residuals are within 5e-10 of one process here,
0.0089 at most, the VJPs within 3e-8 of 0.33); GMRES's first Newton
direction within 2e-5 x max |dx| (9e-7 of 0.14 here: ten Arnoldi steps of
all-reduced projections).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffnet_tpu.data.flow import NSLDCDataset as JNSLDCDataset
from diffnet_tpu.pde.flow import NavierStokes as JNavierStokes
from diffnet_tpu_torch.parallel import run_ranks
from tests import torch_solver_ranks as ranks

WORLD = 4
N = 32
CASES = [(fused, gauge) for fused in (False, True)
         for gauge in ("mean-control", "dirichlet")]


def _payload():
    ds = JNSLDCDataset(domain_sizes=(N, N), Re=100)
    rng = np.random.default_rng(5)
    inputs = np.broadcast_to(ds[0][0][None], (2,) + ds[0][0].shape
                             ).astype(np.float32)
    u, v, p = (rng.random((2, N, N)).astype(np.float32) * 0.1
               for _ in range(3))
    w = rng.standard_normal((3, 2, N, N)).astype(np.float32)
    return {"inputs": inputs, "u": u, "v": v, "p": p, "w": w}


def _jax_calc(p):
    ds = JNSLDCDataset(domain_sizes=(N, N), Re=100)
    m = JNavierStokes(None, ds, domain_size=N, batch_size=2, Re=100)
    R = jax.jit(lambda u, v, p, i: m.calc_residuals((u, v, p), i, None))(
        *(jnp.asarray(p[k]) for k in ("u", "v", "p", "inputs")))
    return [np.asarray(t) for t in R]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    p = _payload()
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, ranks.flow_rank, WORLD, (p,),
                              init_method=init, timeout=120.0, threads=1)
        refs = {"jax": _jax_calc(p), "one": ranks.flow_one_process(p)}
        out = spawned.result()
    return p, out, refs


def _whole(out, get):
    """The global arrays from the ranks' blocks: data index d = r // 2
    holds sample d, space index r % 2 its rows."""
    return np.concatenate([np.concatenate([get(out[2 * d + s])
                                           for s in range(2)], axis=-2)
                           for d in range(2)], axis=0)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
def test_split_ns_residual_matches_jax(results, fused):
    """calc_residuals on 16-row blocks of the 32^2 cavity over data=2 x
    space=2, plain and through K6's row-block entry, against JAX's
    unsharded calc_residuals."""
    _, out, refs = results
    for i, want in enumerate(refs["jax"]):
        got = _whole(out, lambda o: o[fused, "mean-control"]["calc"][i])
        np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("fused,gauge", CASES)
def test_split_mixed_residual_matches_one_process(results, fused, gauge):
    """mixed_residual with either pressure gauge (the mean control's mean
    all-reduced over 'space') against one process on the whole fields."""
    _, out, refs = results
    for i, want in enumerate(refs["one"][fused, gauge]["mixed"]):
        _close(_whole(out, lambda o: o[fused, gauge]["mixed"][i]), want)


@pytest.mark.parametrize("fused,gauge", CASES)
def test_split_residual_vjp_matches_one_process(results, fused, gauge):
    """The fields' gradients of sum(w * R) with each rank its rows' share:
    through the halo exchange's backward and the all-reduce's (the sum of
    the ranks' cotangents), against autograd in one process."""
    _, out, refs = results
    for i, want in enumerate(refs["one"][fused, gauge]["vjp"]):
        _close(_whole(out, lambda o: o[fused, gauge]["vjp"][i]), want)


def test_split_gmres_of_a_mixed_stokes_system_matches_one_process(results):
    """solve_linear(method='gmres', mesh=) on a dict of fields: the 17^2
    Stokes MMS system (PSPG, its forcing at the Gauss points cut to each
    block's element rows) in uneven blocks of 8 and 9 rows, the fields
    stacked as without a mesh. Held, as the NS direction, to the stacked
    iterate's largest entry (u's, 0.98; p's is 0.041): the Krylov steps
    mix the fields, and every field sits ~3e-6 off."""
    _, out, refs = results
    one = refs["one"]["stokes"]
    scale = max(np.abs(v).max() for v in one.values())
    for k, want in one.items():
        for d in range(2):
            got = np.concatenate([out[2 * d + s]["stokes"][k]
                                  for s in range(2)], axis=-2)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-5 * scale, err_msg=k)


def test_split_gmres_on_the_ns_jacobian_matches_one_process(results):
    """One restart cycle of split GMRES on the mean-control residual's
    Jacobian action (torch.func.jvp through the exchange and the
    all-reduce; one sample a data rank) against one process."""
    _, out, refs = results
    for d in range(2):
        want = refs["one"]["gmres"][d]
        got = np.concatenate([out[2 * d + s]["gmres"] for s in range(2)],
                             axis=-2)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
