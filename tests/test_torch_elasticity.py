"""The port's FSDT plate (``pde/elasticity.py``, ``ElasticFSDTDataset``)
against the JAX package's, on the same seeded numpy inputs: the three
Galerkin residuals and both loss norms with their gradients, and a short
LBFGS fit held to the direct solve of the same discrete operator.

Tolerances: float64 (JAX under ``enable_x64``) within 1e-10 of the largest
|JAX value| (the same contractions in another order); float32 within 1e-5
of it (rounding); the dataset bit-equal (the same numpy code); the fit as
the JAX package's own test holds its fit (w within 2% of the largest
|direct w|, the clamped walls below 1e-6); Adam's epoch losses within 1e-5
relative of the JAX Trainer's (as the Poisson trainer test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.data import geometry_datasets as jgd
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde import elasticity as jel
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.data import ElasticFSDTDataset
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.pde import ElasticFSDT
from diffnet_tpu_torch.train import Callback, Trainer

F64_TOL = 1e-10
F32_TOL = 1e-5


def test_dataset_is_bit_equal():
    for n in (9, 17):
        j, t = jgd.ElasticFSDTDataset(domain_size=n, Re=2), \
            ElasticFSDTDataset(domain_size=n, Re=2)
        for a, b in zip(t[0], j[0]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for k in ("x", "y", "bc1", "bc2", "bc3"):
            assert np.array_equal(getattr(t, k), getattr(j, k)), k
        assert len(t) == len(j)


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    ds = jgd.ElasticFSDTDataset(domain_size=n)
    inputs, forcing = ds[0]
    return (rng.standard_normal((3, 2, n, n)), np.stack([inputs] * 2),
            np.stack([forcing] * 2))


def _jax_calc(n, loss_norm, fields, inputs, forcing, **kw):
    jm = jel.ElasticFSDT(None, None, domain_size=n, loss_norm=loss_norm, **kw)

    def fn(f):
        pred = tuple(f)
        return jm.calc_residuals(pred, inputs, forcing), jm.loss(
            pred, inputs, forcing)

    (R, loss), vjp = jax.vjp(fn, fields)
    return R, loss, vjp((tuple(jnp.zeros_like(r) for r in R),
                         jnp.ones_like(loss)))[0]


@pytest.mark.parametrize("loss_norm", ["squared", "frobenius"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_residuals_loss_and_gradient(loss_norm, dtype):
    n = 9
    fields, inputs, forcing = _fields(n)
    kw = {"E": 2.0, "nu_poisson": 0.3, "thickness": 0.2, "q_load": 1.5,
          "w_bc": np.full((n, n), 0.1, np.float32)}
    with jax.enable_x64(dtype == "float64"):
        jf = jnp.asarray(fields, dtype)
        R, loss, grad = jax.jit(
            lambda f, i, fo: _jax_calc(n, loss_norm, f, i, fo, **kw))(
                jf, jnp.asarray(inputs, dtype), jnp.asarray(forcing, dtype))
        R = [np.asarray(r) for r in R]
        loss, grad = float(loss), np.asarray(grad)
    tm = ElasticFSDT(None, None, domain_size=n, loss_norm=loss_norm, **kw)
    tf = torch.tensor(fields, dtype=getattr(torch, dtype), requires_grad=True)
    ti = torch.tensor(inputs, dtype=tf.dtype)
    tfo = torch.tensor(forcing, dtype=tf.dtype)
    tR = tm.calc_residuals(tuple(tf), ti, tfo)
    tl = tm.loss(tuple(tf), ti, tfo)
    tl.backward()
    tol = F64_TOL if dtype == "float64" else F32_TOL
    for got, ref in zip(tR, R):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    assert abs(float(tl.detach()) - loss) <= tol * abs(loss)
    np.testing.assert_allclose(tf.grad.numpy(), grad, rtol=0,
                               atol=tol * np.abs(grad).max())
    # the clamped nodes take w_bc and have zero residual rows
    walls = inputs[0, ..., 3] > 0.5
    w = tm.apply_bcs(tuple(tf), ti)[0].detach().numpy()
    assert np.all(w[:, walls] == np.float32(0.1).astype(dtype))
    assert all(np.all(r.detach().numpy()[:, walls] == 0) for r in tR)


def test_lbfgs_fit_reaches_the_direct_solve():
    """The JAX package's test at 9^2 on the port: a three-field DirectField
    from zeros, the squared norm, LBFGS x 10 for the example's 100 epochs
    (JAX's test runs 200), against the dense solve of the same discrete
    operator (the port's residual in float64, held to JAX's above)."""
    n = 9
    ds = ElasticFSDTDataset(domain_size=n)
    ds.n_samples = 1
    inputs, forcing = ds[0]
    ref = ElasticFSDT(None, None, domain_size=n, loss_norm="squared")
    ti = torch.from_numpy(inputs).double()[None]
    tf = torch.from_numpy(forcing).double()[None]
    N = n * n

    def resid(z):
        R = ref.calc_residuals(tuple(z.reshape(3, 1, n, n)), ti, tf)
        return torch.cat([r.reshape(-1) for r in R])

    zero = torch.zeros(3 * N, dtype=torch.float64)
    A = torch.autograd.functional.jacobian(resid, zero).numpy()
    b = -resid(zero).numpy()
    free = np.abs(A).sum(1) > 0
    z = np.zeros(3 * N)
    z[free] = np.linalg.solve(A[np.ix_(free, free)], b[free])
    w_direct = z[:N].reshape(n, n)

    m = ElasticFSDT(DirectField((n, n), init=np.zeros((n, n)), n_fields=3),
                    ds, domain_size=n, batch_size=1, loss_norm="squared")
    Trainer(max_epochs=100, optimizer="lbfgs", lbfgs_max_iter=10,
            device="cpu").fit(m)
    batch = torch.from_numpy(inputs)[None]
    with torch.no_grad():
        w = m.apply_bcs(m.network(batch), batch)[0][0].numpy()
    assert np.abs(w[0]).max() < 1e-6
    np.testing.assert_allclose(w, w_direct, rtol=0,
                               atol=2e-2 * np.abs(w_direct).max())


def test_adam_fit_matches_jax():
    """Five Adam epochs from a seeded start (a start from zeros would
    scale rounding up where a gradient is nearly zero): the epoch losses
    of both Trainers."""
    n = 9
    init = 0.1 * np.random.default_rng(5).standard_normal((n, n))

    class JLosses(JCallback):
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(float(metrics["loss"]))

    class TLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(float(metrics["loss"]))

    jds, tds = jgd.ElasticFSDTDataset(domain_size=n), ElasticFSDTDataset(
        domain_size=n)
    jds.n_samples = tds.n_samples = 1
    jm = jel.ElasticFSDT(JDirectField((n, n), init=init, n_fields=3), jds,
                         domain_size=n, batch_size=1)
    jrec = JLosses()
    JTrainer(max_epochs=5, optimizer="adam", learning_rate=1e-3,
             callbacks=[jrec]).fit(jm)
    tm = ElasticFSDT(DirectField((n, n), init=init, n_fields=3), tds,
                     domain_size=n, batch_size=1)
    trec = TLosses()
    Trainer(max_epochs=5, optimizer="adam", learning_rate=1e-3,
            callbacks=[trec], device="cpu").fit(tm)
    assert trec.losses[-1] < trec.losses[0]
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
