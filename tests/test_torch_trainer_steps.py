"""The port's ``Trainer(steps_per_call=K)`` on the CPU, where a chunk of K
batches runs as K eager single steps: against ``steps_per_call=1`` at the
sizes of ``tests/test_trainer_features.py::
test_steps_per_call_scan_matches_single_steps`` (a remainder chunk, K = 2,
a ragged last batch), the chunks each case forms, against the JAX
Trainer's ``steps_per_call=4``, under nan_guard, milestones, an optimizer
switch and a resume, and LBFGS, round robin and fast_dev_run taking single
steps whatever K is. The CUDA-graph chunks are held to eager steps on the
card (``tests/test_torch_cuda.py``).

Tolerances: against ``steps_per_call=1`` bit-equal (the same steps in the
same order); against the JAX Trainer the epoch losses within 1e-4
relative (Adam near its eps parts the packages' float32 updates, so they
are held by losses, not field entry by entry: 4.7e-7 to 2.4e-6 apart
on this CPU)."""

import numpy as np
import pytest
import torch

from diffnet_tpu_torch.data import InMemoryDataset, NumpyLoader
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.pde import Poisson2D
from diffnet_tpu_torch.train import OptimizerSwitch, Trainer
from diffnet_tpu_torch.train import trainer as trainer_mod
from tests.test_torch_studies import one_torch_thread  # noqa: F401

N = 17
JAX_LOSS_RTOL = 1e-4


def _boundary(n):
    b = np.zeros((n, n))
    b[[0, -1], :] = 1.0
    b[:, [0, -1]] = 1.0
    return b


def _data(n_items=6):
    """The JAX test's dataset: unit nu, its boundary in channel 2, a random
    forcing."""
    rng = np.random.default_rng(0)
    inputs = np.stack([np.stack([np.ones((N, N)), np.zeros((N, N)),
                                 _boundary(N)], -1)
                       for _ in range(n_items)]).astype(np.float32)
    forcing = rng.random((n_items, N, N, 1)).astype(np.float32)
    return inputs, forcing


def _module(bs, init=None):
    return Poisson2D(DirectField((N, N), init=np.zeros((N, N))
                                 if init is None else init),
                     domain_size=N, batch_size=bs, loss_type="energy")


def _fit(k, bs=2, epochs=3, drop_last=True, init=None, **kw):
    """The field, the trainer and the chunk sizes of a fit at
    ``steps_per_call=k``."""
    m = _module(bs, init)
    kw = {"optimizer": "adam", "learning_rate": 1e-2, **kw}
    tr = Trainer(max_epochs=epochs, steps_per_call=k, seed=0, device="cpu",
                 **kw)
    sizes = []
    build = tr._objective

    def recording(*a, **kwa):
        obj = build(*a, **kwa)
        if obj.chunk is None:
            return obj

        def chunk(batches):
            sizes.append(len(batches))
            return obj.chunk(batches)
        return obj._replace(chunk=chunk)

    tr._objective = recording
    tr.fit(m, NumpyLoader(InMemoryDataset(*_data()), batch_size=bs,
                          shuffle=False, drop_last=drop_last))
    return m.network.field.detach().clone(), tr, sizes


@pytest.mark.parametrize("k, chunks", [(4, [3, 3, 3]),
                                       (2, [2, 1, 2, 1, 2, 1])])
def test_steps_per_call_equals_single_steps(k, chunks):
    """6 items in batches of 2, 3 epochs: K = 4 runs each epoch's 3 batches
    as one remainder chunk, K = 2 as chunks of 2 and 1; both end on the
    single steps' field, with their losses, step for step."""
    u1, tr1, sizes1 = _fit(1)
    uk, trk, sizes = _fit(k)
    assert sizes1 == [] and sizes == chunks
    assert torch.equal(uk, u1)
    assert trk.step_losses == tr1.step_losses and len(trk.step_losses) == 3
    assert trk.state.step == tr1.state.step == 9


def test_steps_per_call_ragged_last_batch_flushes():
    """drop_last=False, batches of 4 and 2: the batch of 2 cannot join the
    pending chunk of one batch of 4, which is flushed first."""
    u1, tr1, _ = _fit(1, bs=4, epochs=2, drop_last=False)
    u2, tr2, sizes = _fit(2, bs=4, epochs=2, drop_last=False)
    assert sizes == [1, 1, 1, 1]
    assert torch.equal(u2, u1) and tr2.step_losses == tr1.step_losses


def test_steps_per_call_matches_jax_trainer():
    """The port's K = 4 against the JAX Trainer's K = 4 (a lax.scan a
    chunk), from one seeded start: the epoch losses."""
    from diffnet_tpu.data.loader import InMemoryDataset as JDataset
    from diffnet_tpu.data.loader import NumpyLoader as JLoader
    from diffnet_tpu.models.field import DirectField as JDirectField
    from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
    from diffnet_tpu.train.trainer import Callback as JCallback
    from diffnet_tpu.train.trainer import Trainer as JTrainer

    init = np.random.default_rng(1).random((N, N)).astype(np.float32)
    jlosses = []

    class Record(JCallback):
        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            jlosses.append(metrics["loss"])

    jm = JPoisson2D(JDirectField((N, N), init=init), domain_size=N,
                    batch_size=2, loss_type="energy")
    JTrainer(max_epochs=3, optimizer="adam", learning_rate=1e-2,
             steps_per_call=4, seed=0, callbacks=[Record()]).fit(
        jm, JLoader(JDataset(*_data()), batch_size=2, shuffle=False))
    losses = []

    class RecordPort(trainer_mod.Callback):
        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            losses.append(metrics["loss"])

    _fit(4, init=init, callbacks=[RecordPort()])
    np.testing.assert_allclose(losses, jlosses, rtol=JAX_LOSS_RTOL)


@pytest.mark.parametrize("kw", [
    {"optimizer": "lbfgs", "lbfgs_max_iter": 3},
    {"fast_dev_run": True},
], ids=["lbfgs", "fast_dev_run"])
def test_single_steps_where_k_does_not_apply(kw):
    """LBFGS and fast_dev_run take single steps whatever K is, as the JAX
    Trainer does."""
    u1, tr1, _ = _fit(1, **kw)
    u4, tr4, sizes = _fit(4, **kw)
    assert sizes == [] and tr4._objectives[0].chunk is None
    assert torch.equal(u4, u1) and tr4.step_losses == tr1.step_losses


def test_round_robin_ignores_k():
    """Round robin alternates its objectives a batch, so K does not
    apply."""
    from tests.test_torch_trainer_features import TWO, _loaders, _params, _Toy

    def run(k):
        m = _Toy({"a": 1.0, "b": 1.0}, objectives=TWO)
        tr = Trainer(max_epochs=4, optimizer=["adam", "lbfgs"],
                     learning_rate=0.2, round_robin=True, steps_per_call=k,
                     device="cpu")
        tr.fit(m, _loaders(3)[1])
        return _params(m), tr

    p1, _ = run(1)
    p4, tr4 = run(4)
    assert p4 == p1 and all(o.chunk is None for o in tr4._objectives)


def test_steps_per_call_milestones_and_switch():
    """Milestones fall between epochs, which is between chunks; an
    OptimizerSwitch (Adam to SGD after epoch 2) rebuilds the chunk."""
    kw = dict(epochs=4, lr_milestones=[1, 3], lr_gamma=0.5,
              callbacks=[OptimizerSwitch(2, "sgd", learning_rate=0.1)])
    u1, tr1, _ = _fit(1, **kw)
    kw["callbacks"] = [OptimizerSwitch(2, "sgd", learning_rate=0.1)]
    u2, tr2, sizes = _fit(2, **kw)
    assert sizes == [2, 1] * 4
    assert isinstance(tr2._objectives[0].optimizer, torch.optim.SGD)
    assert torch.equal(u2, u1) and tr2.step_losses == tr1.step_losses


class _Flaky(Poisson2D):
    """The energy loss, NaN at the calls listed in `bad`."""

    def __init__(self, bad):
        super().__init__(DirectField((N, N), init=np.zeros((N, N))),
                         domain_size=N, batch_size=2, loss_type="energy")
        self.bad, self.calls = set(bad), 0

    def training_loss(self, batch):
        self.calls += 1
        loss = super().training_loss(batch)
        return loss * float("nan") if self.calls in self.bad else loss


def test_steps_per_call_nan_guard(tmp_path):
    """A NaN in epoch 2's second step drops the epoch and restores
    state.ckpt; the steps after it take nan_guard's halved rate, inside
    the chunks as in single steps."""
    def run(k, d):
        d.mkdir()
        m = _Flaky(bad={5})
        tr = Trainer(max_epochs=4, optimizer="adam", learning_rate=1e-2,
                     steps_per_call=k, nan_guard=True, run_dir=str(d),
                     checkpoint=True, device="cpu")
        tr.fit(m, NumpyLoader(InMemoryDataset(*_data()), batch_size=2,
                              shuffle=False))
        return m.network.field.detach().clone(), tr

    u1, tr1 = run(1, tmp_path / "k1")
    u2, tr2 = run(2, tmp_path / "k2")
    assert tr1._nan_restores == tr2._nan_restores == 1
    assert torch.equal(u2, u1) and tr2.step_losses == tr1.step_losses


def test_steps_per_call_resume_is_exact(tmp_path):
    """Two epochs under K = 2, and one then a resume from its state.ckpt
    for one more, end on the same field; invalidate_step_cache (no graph
    on the CPU) leaves the fit as it is."""
    u_unbroken, _, _ = _fit(2, epochs=2)
    _fit(2, epochs=1, run_dir=str(tmp_path), checkpoint=True)
    m = _module(2)
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=1e-2,
                 steps_per_call=2, device="cpu")
    st = tr.fit(m, NumpyLoader(InMemoryDataset(*_data()), batch_size=2,
                               shuffle=False),
                resume_from=str(tmp_path / "state.ckpt"))
    tr.invalidate_step_cache()
    assert st.step == 6
    assert torch.equal(m.network.field.detach(), u_unbroken)
