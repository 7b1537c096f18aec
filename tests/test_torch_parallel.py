"""The port's process meshes and data-parallel training (diffnet_tpu_torch.
parallel, the loader's ``mesh=``, the Trainer's all-reduce) against the
JAX package and the port's own single process.

One module-scoped spawn of 4 gloo ranks on the CPU runs every rank body
(tests/torch_parallel_ranks.py, which imports no JAX); each test asserts on
what the ranks returned. Inputs are drawn with numpy from fixed seeds.

Tolerances: the halo exchange, its backward, shard_batch and the loader's
rows are exact (copies and one add). The data-parallel steps sum the same
terms as one process in another order (four partial sums, then an
all-reduce): losses at rtol 1e-5 and parameters after one Adam step at
atol 1e-6 (an Adam step moves each parameter by ~lr = 1e-3 times
g / |g|, which rounding moves by ~1e-7 of it); the global gradient (one SGD
step at lr 1) at 1e-5 of its largest entry; the all-reduced gradient of
the Adam step entry by entry at 1e-6 of its L2 norm (3.8e-6 apart at most
here, at 1e-8 of the norm it fails); the field after a 10-iteration
LBFGS epoch at 1e-4 of its largest entry (its line searches amplify the
rounding). Against the JAX package the same tolerances hold, its gradients
summed by XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from diffnet_tpu.data.loader import NumpyLoader as JNumpyLoader
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.models.networks import UNet as JUNet
from diffnet_tpu.pde.ibn import IBNPoisson2D as JIBNPoisson2D
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu_torch.interop import (flax_shapes, params_from_jax,
                                       seeded_params)
from diffnet_tpu_torch.models import UNet
from diffnet_tpu_torch.parallel import run_ranks
from diffnet_tpu_torch.parallel.dryrun import dryrun_multigpu
from tests import torch_parallel_ranks as ranks

WORLD = 4
N_IBN, B_IBN = 32, 8
GRAD_RTOL = 1e-6   # the all-reduced gradient, of its L2 norm
N_RES, B_RES = 17, 8


def _payload():
    rng = np.random.default_rng(0)
    net = UNet(3, 1, base_filters=4)
    tree = seeded_params(flax_shapes(net), 1)
    walls = np.zeros((N_RES, N_RES), np.float32)
    walls[[0, -1], :] = 1
    walls[:, [0, -1]] = 1
    res_inputs = np.stack(
        [1.0 + rng.random((B_RES, N_RES, N_RES)),
         np.zeros((B_RES, N_RES, N_RES)),
         np.broadcast_to(walls, (B_RES, N_RES, N_RES))], -1)
    return {
        "ramp_y": np.arange(32 * 4, dtype=np.float32).reshape(32, 4),
        "w_y": rng.standard_normal((WORLD, 10, 4)).astype(np.float32),
        "ramp_z": np.arange(2 * 16 * 3 * 2, dtype=np.float32
                            ).reshape(2, 16, 3, 2),
        "w_z": rng.standard_normal((WORLD, 2, 6, 3, 2)).astype(np.float32),
        "batch": (np.arange(16 * 3, dtype=np.float32).reshape(16, 3),
                  np.ones((5, 5), np.float32), np.float32(2.0),
                  np.arange(16 * 2, dtype=np.float32).reshape(16, 2)),
        "ids": np.arange(28, dtype=np.float32)[:, None],
        "tree": tree,
        "unet_state": params_from_jax(tree),
        "ibn_inputs": rng.random((B_IBN, N_IBN, N_IBN, 3)
                                 ).astype(np.float32),
        "ibn_forcing": rng.random((B_IBN, N_IBN, N_IBN, 1)
                                  ).astype(np.float32),
        "res_inputs": res_inputs.astype(np.float32),
        "res_forcing": rng.random((B_RES, N_RES, N_RES, 1)
                                  ).astype(np.float32),
        "field0": rng.random((N_RES, N_RES)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    p = _payload()
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    body = {k: v for k, v in p.items() if k != "tree"}
    return p, run_ranks(ranks.parallel_rank, WORLD, (body,),
                        init_method=init, timeout=120.0, threads=1)


def _blocks(x, axis):
    return np.split(x, WORLD, axis=axis)


@pytest.mark.parametrize("s", range(WORLD))
def test_halo_exchange_y_as_jax(run, s):
    """JAX's own case (test_parallel.py::test_halo_exchange_y) on 4 ranks:
    each block takes its neighbours' edge rows, the domain edges zeros."""
    p, out = run
    xs = _blocks(p["ramp_y"], 0)
    h = out[s]["halo_y"][0]
    np.testing.assert_array_equal(h[1:-1], xs[s])
    np.testing.assert_array_equal(h[0], xs[s - 1][-1] if s > 0 else 0)
    np.testing.assert_array_equal(h[-1], xs[s + 1][0] if s < WORLD - 1
                                  else 0)


@pytest.mark.parametrize("kind", ["y", "z"])
def test_halo_exchange_backward_returns_halo_cotangents(run, kind):
    """The gradient of sum(w * halo'd block) over the ranks: a block's own
    weights plus the neighbours' weights on its edge slices."""
    p, out = run
    axis = 0 if kind == "y" else 1
    w = p[f"w_{kind}"]
    for s in range(WORLD):
        want = np.take(w[s], range(1, w.shape[axis + 1] - 1), axis=axis)
        want = want.copy()
        first = [slice(None)] * want.ndim
        last = [slice(None)] * want.ndim
        first[axis], last[axis] = 0, -1
        if s > 0:
            want[tuple(first)] += np.take(w[s - 1], -1, axis=axis)
        if s < WORLD - 1:
            want[tuple(last)] += np.take(w[s + 1], 0, axis=axis)
        np.testing.assert_array_equal(out[s][f"halo_{kind}"][1], want)


def test_halo_exchange_z_and_gather(run):
    p, out = run
    xs = _blocks(p["ramp_z"], 1)
    for s in range(WORLD):
        h = out[s]["halo_z"][0]
        np.testing.assert_array_equal(h[:, 1:-1], xs[s])
        np.testing.assert_array_equal(h[:, 0], xs[s - 1][:, -1] if s > 0
                                      else 0)
        np.testing.assert_array_equal(h[:, -1], xs[s + 1][:, 0]
                                      if s < WORLD - 1 else 0)
        np.testing.assert_array_equal(out[s]["gather"], p["ramp_z"])


def test_shard_batch_splits_batch_leaves_and_keeps_shared_ones(run):
    p, out = run
    x, shared, scalar, y = p["batch"]
    for s in range(WORLD):
        got = out[s]["shard_batch"]
        np.testing.assert_array_equal(got[0], _blocks(x, 0)[s])
        np.testing.assert_array_equal(got[1], shared)
        assert got[2] == scalar
        np.testing.assert_array_equal(got[3], _blocks(y, 0)[s])
        # an explicit batch size: the same split
        np.testing.assert_array_equal(out[s]["shard_batch_bs"][0],
                                      got[0])


def test_loader_rows_make_the_jax_loaders_global_batch(run):
    """Every rank draws the JAX loader's permutation; the ranks' rows,
    stacked, are its global batches, epoch after epoch."""
    p, out = run
    jl = JNumpyLoader(ranks.Arrays(p["ids"], p["ids"]), batch_size=8,
                      shuffle=True, seed=3)
    for epoch in range(2):
        want = [b[0] for b in jl]
        assert all(o["loader_len"] == len(want) == 3 for o in out)
        for b, wb in enumerate(want):
            got = np.concatenate([out[s]["loader"][epoch][b]
                                  for s in range(WORLD)])
            np.testing.assert_array_equal(got, wb)


def _numpy_state(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def adam_refs(run):
    """One Adam step on the global batch: the port in one process, and the
    JAX package (value_and_grad and optax.adam) from the same weights;
    each ``(state, loss)``, and the step's gradient."""
    p, _ = run
    net = UNet(3, 1, base_filters=4)
    net.load_state_dict(p["unet_state"])
    m = ranks.ibn_module(net, N_IBN, B_IBN)
    single = ranks.fit_once(m, p["ibn_inputs"], p["ibn_forcing"],
                            optimizer="adam", learning_rate=1e-3)
    jm = JIBNPoisson2D(JUNet(out_channels=1, base_filters=4),
                       source_from="inputs", domain_size=N_IBN,
                       batch_size=B_IBN)
    params = jax.tree.map(jnp.asarray, {"params": p["tree"]})
    batch = (jnp.asarray(p["ibn_inputs"]), jnp.asarray(p["ibn_forcing"]))
    loss, grads = jax.jit(jax.value_and_grad(jm.training_loss))(params,
                                                                 batch)
    opt = optax.adam(1e-3)
    upd, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, upd)
    jstate = params_from_jax(jax.tree.map(np.asarray, new))
    jgrad = params_from_jax(jax.tree.map(np.asarray, grads["params"]))
    return ((single, (_numpy_state(jstate), float(loss))),
            {"single_process": ranks.grads_of(m),
             "jax": _numpy_state(jgrad)})


@pytest.mark.parametrize("ref", ["single_process", "jax"])
def test_data_parallel_adam_step_of_ibn2d(run, adam_refs, ref):
    """A mean-reduced loss: 2 rows a rank, every rank ends on the global
    batch's step (every rank but the first started from other weights)."""
    (single, jax_ref), _ = adam_refs
    state, loss = single if ref == "single_process" else jax_ref
    _, out = run
    for s in range(WORLD):
        got_state, got_loss = out[s]["adam"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        for k, v in state.items():
            np.testing.assert_allclose(got_state[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("ref", ["single_process", "jax"])
def test_data_parallel_adam_gradient_of_ibn2d(run, adam_refs, ref):
    """The all-reduced gradient of that Adam step, entry by entry, within
    GRAD_RTOL of the global gradient's norm (the step itself moves each
    entry by ~lr whatever its gradient's size, so the gradient is what
    holds the all-reduce entry by entry)."""
    _, grads = adam_refs
    want = grads[ref]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in want.values()))
    _, out = run
    for s in range(WORLD):
        for k, g in want.items():
            np.testing.assert_allclose(out[s]["adam_grad"][k], g, rtol=0,
                                       atol=GRAD_RTOL * norm, err_msg=k)


@pytest.fixture(scope="module")
def resmin_refs(run):
    """The resmin fit's global gradient and loss at the start (JAX
    value_and_grad) and the port's single-process SGD and LBFGS epochs."""
    p, _ = run
    single = {name: ranks.fit_once(
        ranks.resmin_module(N_RES, B_RES, p["field0"]), p["res_inputs"],
        p["res_forcing"], **kw)
        for name, kw in (("sgd", {"optimizer": "sgd",
                                  "learning_rate": 1.0}),
                         ("lbfgs", {"optimizer": "lbfgs",
                                    "lbfgs_max_iter": 10}))}
    jm = JPoisson2D(JDirectField((N_RES, N_RES), init=p["field0"]), None,
                    domain_size=N_RES, batch_size=B_RES, loss_type="resmin")
    loss, g = jax.value_and_grad(jm.training_loss)(
        {"field": jnp.asarray(p["field0"])},
        (jnp.asarray(p["res_inputs"]), jnp.asarray(p["res_forcing"])))
    return single, (np.asarray(g["field"]), float(loss))


def test_data_parallel_gradient_of_a_summed_loss_matches_jax(run,
                                                             resmin_refs):
    """resmin sums R^2 over the batch: the ranks' gradients and losses are
    summed, not averaged (one SGD step at lr 1 gives -g)."""
    p, out = run
    single, (g, loss) = resmin_refs
    scale = np.abs(g).max()
    for s in range(WORLD):
        state, got_loss = out[s]["sgd"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(p["field0"] - state["field"], g, rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(state["field"], single["sgd"][0]["field"],
                                   rtol=0, atol=1e-5 * scale)


def test_data_parallel_lbfgs_epoch_matches_one_process(run, resmin_refs):
    """LBFGS reads the loss and the flat gradient in its line search and
    curvature pairs: with both global, every rank takes the one-process
    epoch."""
    _, out = run
    single, _ = resmin_refs
    state, loss = single["lbfgs"]
    scale = np.abs(state["field"]).max()
    for s in range(WORLD):
        got, got_loss = out[s]["lbfgs"]
        np.testing.assert_allclose(got["field"], state["field"], rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(got_loss, loss, rtol=1e-4)
        np.testing.assert_array_equal(got["field"], out[0]["lbfgs"][0][
            "field"])


def _dryrun_ns_objective():
    """The dry run's workload (b) in one process: its draws, in its order
    (after workload (a)'s), the whole 16^2 fields of both samples."""
    import torch

    from diffnet_tpu_torch.data import NSLDCDataset
    from diffnet_tpu_torch.pde import NavierStokes

    rng = np.random.default_rng(0)
    rng.random((4, 32, 32, 3))
    rng.random((4, 32, 32, 1))
    n = 16
    ds = NSLDCDataset(domain_sizes=(n, n), Re=100)
    m = NavierStokes(None, ds, domain_size=n, batch_size=2, Re=100)
    fields = [torch.tensor(rng.random((2, n, n)).astype(np.float32) * 0.1)
              for _ in range(3)]
    R = m.calc_residuals(tuple(fields), torch.tensor(
        np.asarray(ds[0][0], np.float32)[None]), None)
    return float(sum((r.double() ** 2).sum() for r in R))


def test_dryrun_multigpu_on_the_cpu():
    """The dry run's four workloads over its own spawn of 4 gloo ranks: a
    2 x 2 mesh, finite losses, the sharded CG below JAX's 1e-2, and
    workload (b) split over data and space (8-row blocks of one sample a
    rank) with the objective of one process on the whole fields."""
    r = dryrun_multigpu(WORLD, device="cpu", timeout=120.0, threads=1)
    assert (r["data"], r["space"], r["backend"]) == (2, 2, "gloo")
    assert r["cg_rel_res"] < 1e-2
    assert all(np.isfinite(r[k]) for k in ("loss", "ns_loss", "ibn3d_loss"))
    assert r["ibn3d_batch"] == 16
    assert r["ns_block"] == [1, 8, 16]
    np.testing.assert_allclose(r["ns_loss"], _dryrun_ns_objective(),
                               rtol=1e-5)
