"""The port's ``Trainer(optimizer="lbfgs")`` against the JAX Trainer's,
step by step, on the toy problems of ``tests/test_torch_trainer_features.py``.

Both Trainers run ``optax.lbfgs()`` (the port's ``ZoomLBFGS``):
``lbfgs_max_iter`` updates a batch, the loss logged the value at the start
of the last one, the first update of a batch started from the value and
gradient the previous batch left (JAX's ``value_and_grad_from_state``),
and a round-robin objective's L-BFGS over the whole parameter tree, its
other parameters pinned after every update and each turn's first update
evaluated anew.

Tolerances: float64 on both sides (JAX under ``enable_x64``). In float32
the two packages round the Rosenbrock function's gradient apart in the
last bit and its valley turns that into 1e-2 of the loss by the fourth
epoch (on a CPU), so float32 cannot hold them step by step. In float64
every parameter after every epoch and every logged loss lies within
PARAM_RTOL = 1e-6 relative of JAX's (1e-8 at most on a CPU). Each
test that holds the port to JAX also runs a control, the wiring the
Trainer must not have, and requires it to part from JAX's by more than
CONTROL_FACTOR times the tolerance, so that the check can fail. Resumes
and nan_guard's restores are held bit for bit.
"""

import jax
import numpy as np

from diffnet_tpu.data.loader import InMemoryDataset as JInMemoryDataset
from diffnet_tpu.data.loader import NumpyLoader as JNumpyLoader
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.data import InMemoryDataset, NumpyLoader
from diffnet_tpu_torch.train import Callback, Trainer
from diffnet_tpu_torch.train.lbfgs import ZoomLBFGS
from tests.test_torch_trainer_features import (_both, _jax_toy, _loaders,
                                               _params, _Toy)

PARAM_RTOL = 1e-6
CONTROL_FACTOR = 10
F64 = np.float64
ROSEN_START = {"a": -1.2, "b": 1.0}


def _rosenbrock(p):
    return 100.0 * (p["b"] - p["a"] ** 2) ** 2 + (1.0 - p["a"]) ** 2


BATCHES = [1.0, 0.0]


def _rosenbrock_batch(p, batch):
    """Rosenbrock plus a weak pull of `a` towards the batch's value: each
    batch its own loss. A stronger pull makes the cached value, the other
    batch's, lie below every trial of the next step's first search, which
    then fails (in JAX as in the port) and leaves a pair of rounding-level
    curvature (weight ~1e21) that parts the packages in float64 too."""
    return _rosenbrock(p) + 0.01 * (p["a"] - batch[0][0, 0]) ** 2


class _Record:
    """The logged loss and the parameters after every epoch."""

    def __init__(self):
        self.losses, self.params = [], []

    def on_train_start(self, *a):
        pass

    def on_train_end(self, *a):
        pass

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])
        self.params.append({k: float(v) for k, v in state.params.items()})


class _JRecord(_Record, JCallback):
    pass


class _TRecord(_Record, Callback):
    pass


def _records():
    """A pair of recorders and the `callbacks` argument of `_both`."""
    j, t = _JRecord(), _TRecord()
    return j, t, lambda jax_side: [j if jax_side else t]


def _rel_gap(got: _Record, want: _Record) -> float:
    """The largest relative gap of a logged loss or a parameter."""
    gaps = [abs(g - w) / max(abs(w), 1e-300)
            for g, w in zip(got.losses, want.losses)]
    for gp, wp in zip(got.params, want.params):
        gaps += [abs(gp[k] - wp[k]) / max(abs(wp[k]), 1e-300) for k in wp]
    assert len(got.losses) == len(want.losses) > 0
    return max(gaps)


def _batch_loaders(values):
    """A loader of one-row batches holding `values` in order, in each
    package."""
    x = np.asarray(values, np.float64).reshape(-1, 1)
    return (JNumpyLoader(JInMemoryDataset(x, x), batch_size=1),
            NumpyLoader(InMemoryDataset(x, x), batch_size=1))


class _BatchToy(_Toy):
    def training_loss(self, batch):
        return self._loss(self.network, batch)


def _fit_batches(trainer_kw, optimizers):
    """The batch-dependent toy fitted in float64 by the JAX Trainer (under
    ``enable_x64``) and by the port's with each of `optimizers`; returns
    their records, JAX's first."""
    jl, tl = _batch_loaders(BATCHES)
    records = [_JRecord()]
    with jax.enable_x64(True):
        jm = _jax_toy(ROSEN_START, dtype=F64)
        jm.training_loss = _rosenbrock_batch
        JTrainer(callbacks=records, **trainer_kw).fit(jm, jl)
    for opt in optimizers:
        records.append(_TRecord())
        Trainer(callbacks=records[-1:], device="cpu",
                **dict(trainer_kw, optimizer=opt)).fit(
            _BatchToy(ROSEN_START, _rosenbrock_batch, dtype=F64), tl)
    return records


class _FreshEachStep(ZoomLBFGS):
    """The control of the cached pair: evaluates anew at the first of
    every `n` updates (a step's first, on its batch)."""

    def __init__(self, params, n):
        super().__init__(params)
        self.n, self.calls = n, 0

    def step(self, closure, fresh=False):
        self.calls += 1
        return super().step(closure, fresh=fresh or self.calls % self.n == 1)


def test_lbfgs_steps_match_jax_trainer():
    """(a) One objective, Rosenbrock in 2 parameters, 4 epochs of 5
    updates: each epoch's parameters and logged loss are JAX's."""
    j, t, cbs = _records()
    _both(ROSEN_START, dict(max_epochs=4, optimizer="lbfgs",
                            lbfgs_max_iter=5),
          loss=_rosenbrock, callbacks=cbs, dtype=F64)
    assert _rel_gap(t, j) <= PARAM_RTOL, (t.losses, j.losses)
    assert t.losses[-1] < 0.5 * t.losses[0]


def test_lbfgs_carries_the_cached_pair_across_batches():
    """(b) Two batches an epoch, each its own loss: a step's first update
    starts from the value and gradient the previous step's last update
    accepted on the other batch, as JAX's ``value_and_grad_from_state``
    does. The control, which evaluates each step's first update on its
    own batch, parts from JAX's."""
    j, t, c = _fit_batches(
        dict(max_epochs=4, optimizer="lbfgs", lbfgs_max_iter=5),
        ["lbfgs", lambda ps: _FreshEachStep(ps, 5)])
    assert _rel_gap(t, j) <= PARAM_RTOL, (t.losses, j.losses)
    assert _rel_gap(c, j) > CONTROL_FACTOR * PARAM_RTOL


def _coupling(p):
    return 0.5 * (p["a"] - p["b"]) ** 2


# the objectives of test_round_robin_lbfgs_respects_param_mask with a term
# that couples them: there objective 0 ignores b, and each turn of 5
# updates reaches its quadratic's minimum in its own parameter, wherever
# the line search's trials went, so no wiring could part from another
ROUND_ROBIN_OBJECTIVES = [
    lambda p: (p["a"] - 3.0) ** 2 + _coupling(p),
    lambda p: (p["a"] - 10.0) ** 2 + (p["b"] + 2.0) ** 2 + _coupling(p)]
ROUND_ROBIN_MASK = [("a",), ("b",)]


def test_round_robin_lbfgs_runs_over_the_whole_tree():
    """(c) Two coupled objectives with masks, both on LBFGS, 6 turns (one
    an epoch) of 2 updates: the parameters after every turn are JAX's.
    Each objective's memory holds the other's moves, so its directions
    move the other's parameter in the line search's trials (pinned after
    each update). The control, an L-BFGS over each objective's own
    parameter, parts from JAX's."""
    kw = dict(max_epochs=6, optimizer="lbfgs", lbfgs_max_iter=2,
              round_robin=True)
    j, t, cbs = _records()
    _, _, tr, _ = _both({"a": 1.0, "b": 1.0}, kw,
                        objectives=ROUND_ROBIN_OBJECTIVES,
                        mask=ROUND_ROBIN_MASK, callbacks=cbs, dtype=F64)
    assert _rel_gap(t, j) <= PARAM_RTOL, (t.params, j.params)
    assert all(len(o.param_groups[0]["params"]) == 2
               for o in tr.state.optimizer)
    # each turn moves its own parameter only
    for k, (before, after) in enumerate(zip(t.params, t.params[1:])):
        frozen = ROUND_ROBIN_MASK[k % 2][0]
        assert after[frozen] == before[frozen], (k, before, after)
    c = _TRecord()
    Trainer(callbacks=[c], device="cpu",
            **dict(kw, optimizer=[ZoomLBFGS, ZoomLBFGS])).fit(
        _Toy({"a": 1.0, "b": 1.0}, objectives=ROUND_ROBIN_OBJECTIVES,
             mask=ROUND_ROBIN_MASK, dtype=F64), _loaders()[1])
    assert _rel_gap(c, j) > CONTROL_FACTOR * PARAM_RTOL, (c.params, j.params)


def test_lbfgs_resume_is_exact(tmp_path):
    """(d) 2 epochs, then resume_from for 2 more, of two batches each,
    land bit for bit on the unbroken 4-epoch run: the memory ring, its
    weights, the cached value and gradient and the update count come back
    with state.ckpt."""
    kw = dict(optimizer="lbfgs", lbfgs_max_iter=5)
    _, tl = _batch_loaders(BATCHES)

    def toy():
        return _BatchToy(ROSEN_START, _rosenbrock_batch, dtype=F64)

    unbroken, whole = toy(), _TRecord()
    Trainer(max_epochs=4, callbacks=[whole], device="cpu", **kw).fit(
        unbroken, tl)
    Trainer(max_epochs=2, run_dir=str(tmp_path), checkpoint=True,
            device="cpu", **kw).fit(toy(), tl)
    tm, rest = toy(), _TRecord()
    st = Trainer(max_epochs=2, callbacks=[rest], device="cpu", **kw).fit(
        tm, tl, resume_from=str(tmp_path / "state.ckpt"))
    assert _params(tm) == _params(unbroken) and st.step == 8
    assert rest.losses == whole.losses[2:]
    p = next(iter(tm.parameters()))
    assert st.optimizer.state[p]["count"] == 40


class _FlakyObjectives(_Toy):
    """The round-robin toy whose objective loss is NaN at the calls listed
    in `bad`."""

    def __init__(self, bad):
        super().__init__({"a": 1.0, "b": 1.0},
                         objectives=ROUND_ROBIN_OBJECTIVES,
                         mask=ROUND_ROBIN_MASK)
        self.bad, self.calls = set(bad), 0

    def objective_loss(self, idx, batch):
        self.calls += 1
        loss = super().objective_loss(idx, batch)
        return loss * float("nan") if self.calls in self.bad else loss


def test_nan_guard_restores_lbfgs(tmp_path):
    """(e) The first evaluation of epoch 3's turn is NaN: its update takes
    no step, the epoch's loss is NaN, state.ckpt (after epoch 2) is
    restored and training goes on. LBFGS has no rate to halve: the epochs
    after the restore are the unbroken run's, bit for bit."""
    kw = dict(optimizer="lbfgs", lbfgs_max_iter=5, round_robin=True)
    _, tl = _loaders()
    unbroken = _FlakyObjectives(bad=())
    calls = []

    class Calls(Callback):
        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            calls.append(module.calls)

    Trainer(max_epochs=6, callbacks=[Calls()], device="cpu", **kw).fit(
        unbroken, tl)
    m = _FlakyObjectives(bad={calls[2] + 1})
    tr = Trainer(max_epochs=7, nan_guard=True, run_dir=str(tmp_path),
                 checkpoint=True, device="cpu", **kw)
    st = tr.fit(m, tl)
    assert tr._nan_restores == 1 and st.step == 6
    assert _params(m) == _params(unbroken)
    assert np.isfinite(list(_params(m).values())).all()
