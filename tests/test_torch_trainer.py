"""The port's Trainer and loader against the JAX package's.

Adam is held to the JAX Trainer step by step (losses and field at
rtol=1e-5: the two Adam updates are the same formula in float32, and the
gradients agree to ~1e-6 relative). LBFGS, optax's in both Trainers, is
held on the 33^2 resmin fit by the final L2 error, within 10% of the JAX
Trainer's, and the final loss, within 10x: the loss's conditioning parts
the two float32 runs within the first step's updates
(``tests/test_torch_lbfgs_zoom.py``), and the two floors the losses reach
differ with their rounding (the port's K1 route 1.3e-12, JAX's 5.4e-12 on
a CPU), so they agree in the solution reached, not step by step; the
float64 toy problems of ``tests/test_torch_trainer_lbfgs.py`` hold the
Trainers step by step.
"""

import csv
import inspect
from functools import partial

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffnet_tpu.data.loader import NumpyLoader as JNumpyLoader
from diffnet_tpu.data.single_instances import (
    RectangleManufactured as JRectangleManufactured)
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.data import NumpyLoader, RectangleManufactured
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.pde import Poisson2D
from diffnet_tpu_torch.train import (Callback, EarlyStopping, Trainer,
                                     assemble_stencil, coarse_to_fine,
                                     extract_stencil, extract_verified,
                                     load_params, load_state,
                                     module_linear_solve,
                                     multigrid_preconditioner, newton_solve,
                                     ns_newton_solve, query_batched,
                                     solve_linear,
                                     stokes_block_preconditioner,
                                     stokes_linear_solve)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _exact(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y)


def _forcing(x, y):
    return 2 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y)


class _Losses:
    """Collects the per-epoch loss (one step per epoch here)."""

    def __init__(self):
        self.losses = []
        self.metrics = []

    def on_train_start(self, *a):
        pass

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])
        self.metrics.append(metrics)

    def on_train_end(self, *a):
        pass


class _JLosses(_Losses, JCallback):
    pass


class _TLosses(_Losses, Callback):
    pass


def _modules(n, init, n_samples=1, **kw):
    jds, tds = JRectangleManufactured(n), RectangleManufactured(n)
    jds.n_samples = tds.n_samples = n_samples
    kw = dict(domain_size=n, batch_size=1, exact_solution=_exact,
              forcing=_forcing, mms_dirichlet=True, **kw)
    return (JPoisson2D(JDirectField((n, n), init=init), jds, **kw),
            Poisson2D(DirectField((n, n), init=init), tds, **kw))


@pytest.mark.parametrize("loss_type,fused", [("resmin", False),
                                             ("resmin", True),
                                             ("energy", True)])
def test_adam_matches_jax_trainer(loss_type, fused):
    n = 17
    init = np.random.default_rng(0).random((n, n)).astype(np.float32)
    jm, tm = _modules(n, init, loss_type=loss_type)
    jcb, tcb = _JLosses(), _TLosses()
    jst = JTrainer(max_epochs=5, optimizer="adam", learning_rate=1e-3,
                   callbacks=[jcb]).fit(jm)
    if fused:   # the port's kernel path (plain versions on the CPU)
        tm = Poisson2D(DirectField((n, n), init=init), tm.dataset,
                       **dict(tm.kwargs, fused_kernels=True))
    tst = Trainer(max_epochs=5, optimizer="adam", learning_rate=1e-3,
                  callbacks=[tcb], device="cpu").fit(tm)
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=1e-5)
    np.testing.assert_allclose(tst.params["field"].numpy(),
                               np.asarray(jst.params["field"]), rtol=1e-5)
    assert tst.step == 5


def _rel_l2(m, u):
    eL2, _, uex = m.calc_l2_err(u)
    return float(eL2 / uex)


class _TEndLosses(_TLosses):
    """Also records, at every epoch's end, the loss the parameters have and
    the loss at the start of the step's last update (the parameters that
    update started from), the LBFGS update count, and the last line
    search's stepsize and evaluations."""

    def __init__(self):
        super().__init__()
        self.end_losses, self.last_start_losses = [], []
        self.count, self.last_t, self.last_evals = [], [], []

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        super().on_epoch_end(trainer, module, state, epoch, metrics)
        batch = tuple(torch.as_tensor(np.asarray(a))[None]
                      for a in module.dataset[0])
        p = next(iter(module.parameters()))
        st = state.optimizer.state[p]
        with torch.no_grad():
            self.end_losses.append(float(module.training_loss(batch)))
            end = p.detach().clone()
            p.copy_(st["params"].view_as(p))
            self.last_start_losses.append(float(module.training_loss(batch)))
            p.copy_(end)
        self.count.append(st["count"])
        self.last_t.append(st["stepsize"])
        self.last_evals.append(st["linesearch_steps"])


@pytest.fixture(scope="module")
def lbfgs_runs():
    """One 33² resmin LBFGS fit from zeros, 40 epochs of one 10-update
    step, by each Trainer; the port's through its kernel route (K1's plain
    version on the CPU, a third of the element path's time: from the 7th
    epoch on every update's line search runs its 20 evaluations)."""
    n = 33
    jm, tm = _modules(n, np.zeros((n, n)), loss_type="resmin")
    tm = Poisson2D(DirectField((n, n), init=np.zeros((n, n))), tm.dataset,
                   **dict(tm.kwargs, fused_kernels=True))
    jcb, tcb = _JLosses(), _TEndLosses()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
        jst = JTrainer(max_epochs=40, optimizer="lbfgs", lbfgs_max_iter=10,
                       callbacks=[jcb]).fit(jm)
    Trainer(max_epochs=40, optimizer="lbfgs", lbfgs_max_iter=10,
            callbacks=[tcb], device="cpu").fit(tm)
    return jm, jst, jcb, tm, tcb


def test_lbfgs_final_l2_matches_jax_trainer(lbfgs_runs):
    jm, jst, _, tm, _ = lbfgs_runs
    rel_j = _rel_l2(jm, jm.network.apply(jst.params)[0])
    with torch.no_grad():
        rel_t = _rel_l2(tm, tm.network()[0])
    assert abs(rel_t - rel_j) <= 0.1 * rel_j, (rel_t, rel_j)


def test_lbfgs_final_loss_within_10x_of_jax_trainer(lbfgs_runs):
    _, _, jcb, _, tcb = lbfgs_runs
    assert tcb.losses[-1] <= 10 * jcb.losses[-1], (tcb.losses[-1],
                                                   jcb.losses[-1])


def test_lbfgs_logs_the_loss_of_its_end_parameters(lbfgs_runs):
    """The loss a step logs is the JAX Trainer's: the value at the start
    of its last update (the loss of the parameters that update started
    from), not the loss of those the step ends on."""
    tcb = lbfgs_runs[-1]
    np.testing.assert_allclose(tcb.losses, tcb.last_start_losses, rtol=1e-6)
    assert tcb.losses[0] != tcb.end_losses[0]


def test_lbfgs_step_runs_max_iter_below_absolute_tolerances(lbfgs_runs):
    """torch's default tolerances would end a step at once below 1e-9;
    the first epochs start there and still run all 10 updates."""
    tcb = lbfgs_runs[-1]
    assert max(tcb.losses[:2]) < 1e-9, tcb.losses[:2]
    assert tcb.count[:3] == [10, 20, 30], tcb.count


def test_lbfgs_step_after_a_failed_line_search_repeats_it(lbfgs_runs):
    """At float32's floor no stepsize meets both of the line search's
    conditions: each search runs its 20 evaluations, fails, and takes its
    safe step (optax's ``_try_safe_step``), a stepsize in (0, 1) of
    sufficient decrease (approximate: within 1e-6 of the loss), where
    torch's L-BFGS would end the step; the step still runs its 10 updates.
    From some epoch on every epoch's last search fails so, for most of the
    run, and the loss never rises above that approximate decrease."""
    tcb = lbfgs_runs[-1]
    assert tcb.count == [10 * (k + 1) for k in range(len(tcb.count))]
    k = max(i for i, n in enumerate(tcb.last_evals) if n < 20) + 1
    assert k < len(tcb.last_evals) - 5, tcb.last_evals
    assert all(0 < t < 1 for t in tcb.last_t[k:]), tcb.last_t
    assert all(e <= (1 + 1e-6) * s
               for e, s in zip(tcb.end_losses, tcb.losses)), (
        tcb.end_losses, tcb.losses)


def test_sgd_lowers_the_loss_and_logs(tmp_path):
    n = 17
    init = np.random.default_rng(1).random((n, n)).astype(np.float32)
    _, tm = _modules(n, init, n_samples=2, loss_type="energy")
    cb = _TLosses()
    tr = Trainer(max_epochs=3, optimizer="sgd", learning_rate=100.0,
                 run_dir=str(tmp_path), checkpoint=True, callbacks=[cb],
                 device="cpu")
    st = tr.fit(tm)
    assert cb.losses[-1] < cb.losses[0]
    assert len(tr.step_losses) == 2 and len(tr.epoch_times) == 3
    with open(tmp_path / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    assert float(rows[-1]["loss"]) == pytest.approx(cb.losses[-1])
    last = load_params(str(tmp_path / "last.ckpt"))
    torch.testing.assert_close(last["field"], st.params["field"])
    assert set(load_params(str(tmp_path / "best.ckpt"))) == {"field"}
    state = load_state(str(tmp_path / "state.ckpt"))
    assert state["step"] == 6 and "state" in state["opt_state"]


def test_fit_takes_params_val_loader_and_early_stopping():
    n = 9
    _, tm = _modules(n, np.zeros((n, n)), n_samples=1, loss_type="resmin")
    start = {"field": torch.full((n, n), 0.5)}
    val = NumpyLoader(tm.dataset, batch_size=1)
    tm.network.load_state_dict(start)
    with torch.no_grad():
        loss_at_start = float(tm.training_loss(next(iter(val))))
    tm.network.load_state_dict({"field": torch.zeros(n, n)})
    cb = _TLosses()
    stop = EarlyStopping(monitor="loss", min_delta=1e9, patience=2)
    tr = Trainer(max_epochs=10, optimizer="adam", callbacks=[stop, cb],
                 device="cpu")
    tr.fit(tm, params=start, val_dataloader=val)
    assert cb.losses[0] == pytest.approx(loss_at_start, rel=1e-6)
    assert len(cb.losses) == 3 and tr.should_stop
    assert all("val_loss" in m for m in cb.metrics)


def test_fast_dev_run_takes_one_step():
    n = 9
    _, tm = _modules(n, np.zeros((n, n)), n_samples=4, loss_type="resmin")
    tr = Trainer(max_epochs=5, fast_dev_run=True, device="cpu")
    assert tr.fit(tm).step == 1


class _Indexed:
    """Sample i is (full(i), full(-i))."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return (np.full((2, 2, 1), i, np.float32),
                np.full((2, 2, 1), -i, np.float32))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_matches_jax_order(shuffle, drop_last):
    jl = JNumpyLoader(_Indexed(), batch_size=3, shuffle=shuffle,
                      drop_last=drop_last, seed=5)
    tl = NumpyLoader(_Indexed(), batch_size=3, shuffle=shuffle,
                     drop_last=drop_last, seed=5)
    assert len(jl) == len(tl)
    for _ in range(2):   # two epochs: the generator state carries over
        for jb, tb in zip(jl, tl, strict=True):
            for a, b in zip(tb, jb, strict=True):
                assert isinstance(a, torch.Tensor)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(device="cuda")


def test_zero_batches_raise():
    n = 9
    _, tm = _modules(n, np.zeros((n, n)), n_samples=1, loss_type="resmin")
    tm.batch_size = 2
    with pytest.raises(ValueError, match="zero batches"):
        Trainer(device="cpu").fit(tm)


def _tiny_module(n=9):
    _, tm = _modules(n, np.zeros((n, n)), loss_type="resmin")
    return tm


def _tiny_stokes(kind="stokes"):
    from diffnet_tpu_torch.data import StokesMMSDataset
    from diffnet_tpu_torch.pde import NavierStokes, StokesMMS

    ds = StokesMMSDataset(9)
    return (StokesMMS if kind == "stokes" else NavierStokes)(
        None, ds, domain_size=9, batch_size=1)


ENTRY_POINTS = {   # entry point -> a call that leaves `device` at its default
    "Trainer": (Trainer, lambda: Trainer()),
    "solve_linear": (solve_linear,
                     lambda: solve_linear(lambda u: u - 1.0, (5, 5))),
    "module_linear_solve": (module_linear_solve,
                            lambda: module_linear_solve(_tiny_module())),
    "multigrid_preconditioner": (
        multigrid_preconditioner,
        lambda: multigrid_preconditioner(_tiny_module, 9, n_coarse=5)),
    "coarse_to_fine": (coarse_to_fine, lambda: coarse_to_fine(
        lambda n: (lambda m: (m, m.network))(_tiny_module(n)), [9], 1)),
    "extract_stencil": (extract_stencil,
                        lambda: extract_stencil(lambda u: 2.0 * u, (5, 5))),
    "extract_verified": (extract_verified,
                         lambda: extract_verified(lambda u: 2.0 * u, (5, 5))),
    "assemble_stencil": (assemble_stencil,
                         lambda: assemble_stencil(lambda u: u - 1.0, (5, 5))),
    "newton_solve": (newton_solve,
                     lambda: newton_solve(lambda x: x - 1.0, torch.zeros(3))),
    "stokes_block_preconditioner": (
        stokes_block_preconditioner,
        lambda: stokes_block_preconditioner(_tiny_stokes())),
    "stokes_linear_solve": (stokes_linear_solve,
                            lambda: stokes_linear_solve(_tiny_stokes())),
    "ns_newton_solve": (ns_newton_solve,
                        lambda: ns_newton_solve(_tiny_stokes("ns"))),
    "query_batched": (query_batched,
                      lambda: query_batched(_tiny_module(), _tiny_module()
                                            .dataset, batch_size=1)),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Every entry point runs on the card unless the caller asks for the
    CPU: its ``device`` defaults to "cuda", and without CUDA the default
    raises instead of falling back to the CPU."""
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        call()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
