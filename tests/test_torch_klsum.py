"""The port's parametric KL-sum UQ path against the JAX package's, on the same
numpy inputs: the KL generator (``data/gen_input.py``), the host library's
binding (``utils/native.py``), ``KLSumStochastic`` and
``KLSumSingleInstance``, the loader's gather, a 5-step energy training run
of a narrow ``GoodNetwork`` and the statistical query.

Tolerances: the generator's arrays and the datasets bit-equal (the same
numpy code, and the same C++ source for the fields); the host library
against its numpy versions within 2e-6 for the KL fields (a float64 sum
rounded once to float32 in either order), bit-equal for the gather, 1e-5
for the 2D winding number (sums of ~1e2 float32 terms in other orders)
and 2e-5 for the 3D one (r^-3 terms up to ~1e2); the 5-step trajectory's
losses within 1e-4 relative and the query's fields within 1e-4 of their
largest entry (Adam's float32 updates in other orders, five times).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.data import gen_input as jgen
from diffnet_tpu.data.loader import NumpyLoader as JNumpyLoader
from diffnet_tpu.data.parametric import KLSumStochastic as JKLSumStochastic
from diffnet_tpu.data.single_instances import (
    KLSumSingleInstance as JKLSumSingleInstance)
from diffnet_tpu.models.networks import GoodNetwork as JGoodNetwork
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu.train.query import query_statistical as jquery_statistical
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu.utils import native as jnative
from diffnet_tpu_torch.data import (InMemoryDataset, KLSumSingleInstance,
                                    KLSumStochastic, NumpyLoader)
from diffnet_tpu_torch.data import gen_input as tgen
from diffnet_tpu_torch.interop import params_from_jax
from diffnet_tpu_torch.models import GoodNetwork
from diffnet_tpu_torch.pde import Poisson2D
from diffnet_tpu_torch.train import Callback, Trainer, query_statistical
from diffnet_tpu_torch.utils import native

from .test_torch_networks import flax_params

KL_ATOL = 2e-6
TRAJ_RTOL = 1e-4


def _coeffs(b=6, k=6, seed=0):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (b, k))


# -- gen_input ----------------------------------------------------------------

@pytest.mark.parametrize("eta", [0.5, 0.25, 1.3])
def test_omega_equals_jax(eta):
    np.testing.assert_array_equal(
        tgen.calculate_omega_based_on_eta(eta, 10),
        jgen.calculate_omega_based_on_eta(eta, 10))


@pytest.mark.parametrize("nsd,n", [(2, 17), (2, 64), (3, 9)])
def test_generate_diffusivity_tensor_equals_jax(nsd, n):
    for c in _coeffs(3, 4, seed=nsd):
        np.testing.assert_array_equal(
            tgen.generate_diffusivity_tensor(c, output_size=n, nsd=nsd,
                                             n_sum_nu=3),
            jgen.generate_diffusivity_tensor(c, output_size=n, nsd=nsd,
                                             n_sum_nu=3))


def test_kl_sums_grids_and_sobol_equal_jax():
    c = _coeffs(1)[0]
    x, y = tgen.grid2D(7, 5)
    np.testing.assert_array_equal(
        tgen.construct_KL_sum_2D(x, y, c, 0.3, 0.7),
        jgen.construct_KL_sum_2D(x, y, c, 0.3, 0.7))
    x, y, z = tgen.grid3D(5, 4, 3)
    np.testing.assert_array_equal(
        tgen.construct_KL_sum_3D(x, y, z, c),
        jgen.construct_KL_sum_3D(x, y, z, c))
    np.testing.assert_array_equal(tgen.sobol_coefficients(64, 6, seed=3),
                                  jgen.sobol_coefficients(64, 6, seed=3))


# -- native -------------------------------------------------------------------

@pytest.mark.parametrize("eta,n_sum_nu,k", [(0.5, 6, 6), (0.25, 3, 4)])
def test_kl_fields_native_plain_and_jax(eta, n_sum_nu, k):
    """The host library's fields within 2e-6 of the numpy version's, and
    equal to the JAX package's binding of the same source."""
    c = _coeffs(5, k, seed=k)
    got = native.kl_diffusivity_batch(c, 33, eta=eta, n_sum_nu=n_sum_nu)
    assert got.dtype == np.float32 and got.shape == (5, 33, 33)
    np.testing.assert_allclose(
        got, native.kl_diffusivity_batch_plain(c, 33, eta=eta,
                                               n_sum_nu=n_sum_nu),
        rtol=0, atol=KL_ATOL)
    np.testing.assert_array_equal(
        got, jnative.kl_diffusivity_batch(c, 33, eta=eta, n_sum_nu=n_sum_nu))


def test_gather_native_equals_plain():
    rng = np.random.default_rng(6)
    for src in (rng.random((10, 5, 3)).astype(np.float32),
                rng.integers(0, 255, (7, 4), dtype=np.uint8),
                rng.random(9)):
        for idx in ([3, 1, 3, 0], [], list(range(len(src)))):
            got = native.gather_batch(src, idx)
            np.testing.assert_array_equal(got, src[np.asarray(idx, np.int64)])
            np.testing.assert_array_equal(
                got, native.gather_batch_plain(src, idx))
    for fn in (native.gather_batch, native.gather_batch_plain):
        with pytest.raises(IndexError):
            fn(np.zeros((4, 2)), [4])
        with pytest.raises(TypeError):
            fn(np.array([None, 1], dtype=object), [0])


def _cloud(nsd, B=2, P=200, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, (B, P))
    if nsd == 2:
        d = np.stack([np.cos(th), np.sin(th)], -1)
        area = 2 * np.pi * 0.3 / P
    else:
        ph = np.arccos(rng.uniform(-1, 1, (B, P)))
        d = np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th),
                      np.cos(ph)], -1)
        area = 4 * np.pi * 0.3**2 / P
    q = rng.random((65, nsd))
    return tuple(a.astype(np.float32) for a in (
        0.5 + 0.3 * d, d, np.full((B, P), area), q))


@pytest.mark.parametrize("nsd,atol", [(2, 1e-5), (3, 2e-5)])
def test_winding_native_equals_plain_and_jax(nsd, atol):
    args = _cloud(nsd)
    host = getattr(native, f"winding_number_{nsd}d_host")
    plain = getattr(native, f"winding_number_{nsd}d_host_plain")
    got = host(*args)
    assert got.shape == (2, 65)
    np.testing.assert_allclose(got, plain(*args), rtol=0, atol=atol)
    np.testing.assert_array_equal(
        got, getattr(jnative, f"winding_number_{nsd}d_host")(*args))
    with pytest.raises(ValueError, match="queries"):
        host(*args[:3], np.zeros((4, nsd + 1), np.float32))


def test_build_failure_raises_with_the_compiler_error(monkeypatch, tmp_path):
    """No silent fallback: a compiler that does not run, or a build that
    fails, raises RuntimeError with what went wrong, and so does every
    entry point that needs the library."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.kl_diffusivity_batch(_coeffs(1), 9)
    assert not native.available()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed") as e:
        native.gather_batch(np.zeros((2, 2)), [0])
    assert "bad.cpp" in str(e.value)
    # no library and no temporary file is left behind
    assert sorted(os.listdir(tmp_path)) == ["bad.cpp"]


def test_library_builds_into_the_port(monkeypatch, tmp_path):
    """The library is built from the repository's csrc/diffnet_host.cpp
    into the port's _build directory; a missing one is built at first
    use."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.SOURCE == os.path.join(root, "csrc", "diffnet_host.cpp")
    assert native.LIB_PATH == os.path.join(root, "diffnet_tpu_torch",
                                           "_build", "libdiffnet_host.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "b" / "l.so"))
    assert native.available() and (tmp_path / "b" / "l.so").exists()


# -- datasets and loader ------------------------------------------------------

def test_klsum_stochastic_equals_jax(tmp_path):
    c = jgen.sobol_coefficients(16, 6, seed=0)
    path = tmp_path / "sobol.npy"
    np.save(path, c)
    for src in (c, str(path)):
        t, j = KLSumStochastic(src, domain_size=17), \
            JKLSumStochastic(src, domain_size=17)
        assert len(t) == len(j) == 16
        np.testing.assert_array_equal(t.dataset, j.dataset)
        for i in (0, 7, 15):
            for a, b in zip(t[i], j[i]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    inputs, forcing = t[3]
    assert inputs.shape == (17, 17, 3) and not forcing.any()
    assert np.all(inputs[..., 0] > 0)
    assert inputs[:, 0, 1].all() and inputs[:, -1, 2].all()


def test_klsum_single_instance_equals_jax(tmp_path):
    path = tmp_path / "coeff.txt"
    np.savetxt(path, _coeffs(1)[0])
    t, j = KLSumSingleInstance(str(path), 33), \
        JKLSumSingleInstance(str(path), 33)
    assert len(t) == len(j) == 1000
    for a, b in zip(t[5], j[5]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        KLSumSingleInstance(str(tmp_path / "missing.txt"))


def test_in_memory_batch_equals_stacked_items():
    """InMemoryDataset.batch (the host library's gather) equals stacking
    __getitem__, negative indices included, through the loader too."""
    rng = np.random.default_rng(7)
    inputs = rng.random((13, 4, 4, 2)).astype(np.float32)
    forcing = rng.random((13, 4, 4, 1)).astype(np.float32)
    ds = InMemoryDataset(inputs, forcing)
    idx = [3, -1, 0, 3]
    for got, k in zip(ds.batch(idx), range(2)):
        np.testing.assert_array_equal(
            got, np.stack([ds[i][k] for i in idx]))

    class Items:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            return ds[i]

    fast = list(NumpyLoader(ds, batch_size=4, shuffle=True, seed=3))
    slow = list(NumpyLoader(Items(), batch_size=4, shuffle=True, seed=3))
    for a, b in zip(fast, slow):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# -- training and query ------------------------------------------------------

def _klsum_pair(n=16, filters=4):
    jnet = JGoodNetwork(in_dim=n, out_dim=n, filters=filters)
    tnet = GoodNetwork(in_dim=n, out_dim=n, in_channels=3, filters=filters)
    params = jax.tree.map(np.asarray, flax_params(
        jnet, np.zeros((1, n, n, 3), np.float32)))
    tnet.load_state_dict(params_from_jax(params))
    return jnet, tnet, params


@pytest.mark.parametrize("fused", [True, False])
def test_klsum_energy_training_matches_jax(fused):
    """5 Adam steps (lr 1e-3, one batch of 8 KL-sum samples an epoch) of
    the energy at 16^2 with a narrow GoodNetwork carried in from flax: each
    step's loss within 1e-4 relative of the JAX Trainer's, and the loss at
    the end state too. With fused_kernels the port's energy goes through
    K3's autograd function (its plain version on the CPU)."""
    n = 16
    ds = KLSumStochastic(jgen.sobol_coefficients(8, 6, seed=0),
                         domain_size=n)
    jnet, tnet, params = _klsum_pair(n)
    kw = dict(domain_size=n, batch_size=8, loss_type="energy",
              bc1_value=1.0, bc2_value=0.0)
    jm = JPoisson2D(jnet, ds, **kw)
    tm = Poisson2D(tnet, ds, fused_kernels=fused, **kw)

    class JRec(JCallback):
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])

    class TRec(Callback):
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])

    jrec, trec = JRec(), TRec()
    state = JTrainer(max_epochs=5, optimizer="adam", learning_rate=1e-3,
                     callbacks=[jrec]).fit(
        jm, JNumpyLoader(ds, batch_size=8, shuffle=True, seed=0),
        params=jax.tree.map(jnp.asarray, params))
    Trainer(max_epochs=5, optimizer="adam", learning_rate=1e-3,
            callbacks=[trec], device="cpu").fit(
        tm, NumpyLoader(ds, batch_size=8, shuffle=True, seed=0))
    assert jrec.losses[-1] < jrec.losses[0]
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=TRAJ_RTOL)
    jb = jax.tree.map(jnp.asarray, next(iter(JNumpyLoader(ds, 8))))
    with torch.no_grad():
        tl = float(tm.training_loss(next(iter(NumpyLoader(ds, 8)))))
    np.testing.assert_allclose(tl, float(jm.training_loss(state.params, jb)),
                               rtol=TRAJ_RTOL)


def test_klsum_query_statistical_matches_jax(tmp_path):
    n = 16
    ds = KLSumStochastic(jgen.sobol_coefficients(8, 6, seed=1),
                         domain_size=n)
    jnet, tnet, params = _klsum_pair(n)
    kw = dict(domain_size=n, loss_type="energy", bc1_value=1.0,
              bc2_value=0.0)
    jmean, jsdev, ju = jquery_statistical(
        JPoisson2D(jnet, **kw), jax.tree.map(jnp.asarray, params), ds,
        batch_size=3)
    tmean, tsdev, tu = query_statistical(
        Poisson2D(tnet, **kw), ds, batch_size=3, out_dir=str(tmp_path),
        device="cpu")
    assert tu.shape == (8, n, n)
    for a, b in ((tu, ju), (tmean, jmean), (tsdev, jsdev)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=TRAJ_RTOL * np.abs(b).max())
    np.testing.assert_array_equal(np.load(tmp_path / "q_sdev.npy"), tsdev)
