"""The port's Trainer features against the JAX Trainer's, on the same toy
problems as ``tests/test_trainer_features.py``: round-robin objectives
(Adam, LBFGS, optimizer lists, parameter scoping, per-objective
schedules), remat, exact resume (also in round-robin mode and after an
optimizer switch), nan_guard, the profiler, the ``.inp`` config,
``OptimizerSwitch``, optimizer factories, ``TensorBoardLogger``, the
Navier-Stokes objective protocol and ``pretrain_autoencoder``.

Tolerances: the port's end parameters within 1e-4 of the JAX Trainer's
where both run Adam or SGD on the same scalar losses (float32 updates in
another order, up to 200 steps); LBFGS runs are held here, as the JAX
tests hold them, by the optimum they reach (both Trainers run optax's
L-BFGS, held step by step in ``tests/test_torch_trainer_lbfgs.py``); remat
and resume bit-equal; the NS objectives
within 1e-5 relative of JAX's (gradients of their largest entry); the
pretrained autoencoder's reconstructions within 1e-4 of their largest
entry (not its raw parameters: a bias before a normalisation has a zero
gradient up to rounding, which Adam scales up to steps of the learning
rate, in either package its own way).
"""

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from diffnet_tpu.config import (RunConfig as JRunConfig,
                                add_config_args as jadd_config_args,
                                config_from_args as jconfig_from_args,
                                config_from_inp as jconfig_from_inp)
from diffnet_tpu.data.flow import NSLDCDataset as JNSLDCDataset
from diffnet_tpu.data.loader import InMemoryDataset as JInMemoryDataset
from diffnet_tpu.data.loader import NumpyLoader as JNumpyLoader
from diffnet_tpu.data.single_instances import (
    RectangleManufactured as JRectangleManufactured)
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.models.networks import AE as JAE
from diffnet_tpu.pde.flow import NavierStokes as JNavierStokes
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu.train.pretrain import (
    ArrayImageDataset as JArrayImageDataset,
    pretrain_autoencoder as jpretrain_autoencoder)
from diffnet_tpu.train.trainer import OptimizerSwitch as JOptimizerSwitch
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.config import (RunConfig, add_config_args,
                                      config_from_args, config_from_inp)
from diffnet_tpu_torch.data import (InMemoryDataset, NSLDCDataset,
                                    NumpyLoader, RectangleManufactured,
                                    SyntheticPointClouds)
from diffnet_tpu_torch.interop import params_from_jax
from diffnet_tpu_torch.models import AE, DirectField
from diffnet_tpu_torch.pde import (IBNPoisson2D, NavierStokes, Poisson2D,
                                   ldc_bcs)
from diffnet_tpu_torch.train import (ArrayImageDataset, OptimizerSwitch,
                                     TensorBoardLogger, Trainer, load_state,
                                     pretrain_autoencoder)
from diffnet_tpu_torch.train.lbfgs import ZoomLBFGS

PARAM_ATOL = 1e-4
NS_RTOL = 1e-5


# -- toy modules: the JAX tests' scalar problems in both packages ------------

def _jax_toy(init, loss=None, objectives=None, mask=None, lr=0.1,
             dtype=np.float32):
    class Net:
        def init(self, rng, x):
            return {k: jnp.asarray(v, dtype) for k, v in init.items()}

        def apply(self, params, x):
            return params

    class Toy:
        dataset = None
        batch_size = 1
        learning_rate = lr
        network = Net()

        def init_params(self, rng, batch):
            return self.network.init(rng, None)

        def training_loss(self, params, batch):
            return loss(params)

    m = Toy()
    if objectives is not None:
        m.num_objectives = len(objectives)
        m.objective_loss = lambda idx, params, batch: objectives[idx](params)
    if mask is not None:
        m.objective_param_mask = lambda idx, params: {
            k: k in mask[idx] for k in params}
    return m


class _Toy(nn.Module):
    """The port's counterpart: the scalars are the network's parameters."""

    def __init__(self, init, loss=None, objectives=None, mask=None, lr=0.1,
                 dtype=np.float32):
        super().__init__()
        self.network = nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(np.asarray(v, dtype)))
            for k, v in init.items()})
        self.dataset, self.batch_size, self.learning_rate = None, 1, lr
        self._loss, self._objectives, self._mask = loss, objectives, mask
        if objectives is not None:
            self.num_objectives = len(objectives)
        self.seen: list[int] = []

    def training_loss(self, batch):
        return self._loss(self.network)

    def objective_loss(self, idx, batch):
        self.seen.append(idx)
        return self._objectives[idx](self.network)

    def objective_param_mask(self, idx):
        return None if self._mask is None else tuple(self._mask[idx])


def _loaders(n=1):
    z = np.zeros((n, 1), np.float32)
    return (JNumpyLoader(JInMemoryDataset(z, z), batch_size=1),
            NumpyLoader(InMemoryDataset(z, z), batch_size=1))


def _params(state_or_module):
    if isinstance(state_or_module, nn.Module):
        return {k: float(v.detach())
                for k, v in state_or_module.network.items()}
    return {k: float(v) for k, v in state_or_module.params.items()}


def _both(init, trainer_kw, loss=None, objectives=None, mask=None, lr=0.1,
          n=1, callbacks=lambda jax_side: [], dtype=np.float32):
    """Fit the toy in both packages, its parameters of `dtype` (float64:
    JAX under ``enable_x64``); returns (JAX's params, the port's params,
    the port's trainer, the port's module)."""
    jl, tl = _loaders(n)
    with jax.enable_x64(dtype == np.float64):
        jst = JTrainer(callbacks=callbacks(True), **trainer_kw).fit(
            _jax_toy(init, loss, objectives, mask, lr, dtype), jl)
    tm = _Toy(init, loss, objectives, mask, lr, dtype)
    tr = Trainer(callbacks=callbacks(False), device="cpu", **trainer_kw)
    tr.fit(tm, tl)
    return _params(jst), _params(tm), tr, tm


def _close(got, want, atol=PARAM_ATOL):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= atol, (k, got[k], want[k])


TWO = [lambda p: (p["a"] - 3.0) ** 2, lambda p: (p["b"] + 2.0) ** 2]


# -- round robin --------------------------------------------------------------

def test_round_robin_multi_objective():
    want, got, tr, _ = _both(
        {"a": 1.0, "b": 1.0}, dict(max_epochs=200, optimizer="adam",
                                   learning_rate=0.1, round_robin=True),
        objectives=TWO)
    assert abs(got["a"] - 3.0) < 0.1 and abs(got["b"] + 2.0) < 0.1
    _close(got, want)
    assert isinstance(tr.state.optimizer, tuple)


def test_round_robin_lbfgs():
    want, got, _, _ = _both(
        {"a": 1.0, "b": 1.0}, dict(max_epochs=8, optimizer="lbfgs",
                                   lbfgs_max_iter=5, round_robin=True),
        objectives=TWO, lr=1.0)
    for p in (want, got):
        assert abs(p["a"] - 3.0) < 1e-3 and abs(p["b"] + 2.0) < 1e-3


def test_round_robin_per_objective_opt_state_and_scoping():
    """One optimizer per objective; a scoped objective moves only its own
    parameter though its loss depends on both."""
    objs = [lambda p, t=t: (p["field_0"] + 0.1 * p["field_1"] - t) ** 2
            for t in (3.0, -2.0)]
    mask = [("field_0",), ("field_1",)]
    want, got, tr, _ = _both(
        {"field_0": 1.0, "field_1": 1.0},
        dict(max_epochs=1, optimizer="adam", learning_rate=0.1,
             round_robin=True), objectives=objs, mask=mask)
    assert len(tr.state.optimizer) == 2
    assert got["field_0"] != 1.0 and got["field_1"] == 1.0
    _close(got, want)


def test_round_robin_optimizer_list():
    """[Adam, LBFGS]: the LBFGS objective converges exactly, the Adam one
    moves as JAX's does; a list without round_robin raises."""
    want, got, tr, _ = _both(
        {"a": 1.0, "b": 1.0}, dict(max_epochs=40, optimizer=["adam", "lbfgs"],
                                   learning_rate=0.2, lbfgs_max_iter=5,
                                   round_robin=True),
        objectives=TWO, lr=0.2, n=2)
    assert abs(got["b"] + 2.0) < 1e-3 and abs(got["a"] - 3.0) < 0.5
    assert abs(got["a"] - want["a"]) <= PARAM_ATOL
    assert isinstance(tr.state.optimizer[1], ZoomLBFGS)
    with pytest.raises(ValueError):
        Trainer(optimizer=["adam", "adam"], device="cpu").fit(
            _Toy({"a": 1.0}, objectives=TWO), _loaders()[1])
    with pytest.raises(ValueError, match="3 optimizers given for 2"):
        Trainer(optimizer=["adam"] * 3, round_robin=True, device="cpu").fit(
            _Toy({"a": 1.0, "b": 1.0}, objectives=TWO), _loaders()[1])


def test_round_robin_lbfgs_respects_param_mask():
    objs = [lambda p: (p["a"] - 3.0) ** 2,
            lambda p: (p["a"] - 10.0) ** 2 + (p["b"] + 2.0) ** 2]
    want, got, _, _ = _both(
        {"a": 1.0, "b": 1.0}, dict(max_epochs=30, optimizer="lbfgs",
                                   lbfgs_max_iter=5, round_robin=True),
        objectives=objs, mask=[("a",), ("b",)], lr=0.2, n=2)
    for p in (want, got):
        assert abs(p["a"] - 3.0) < 1e-3 and abs(p["b"] + 2.0) < 1e-3


def test_round_robin_schedules_each_objective():
    """lr_milestones count each objective's own updates, as the JAX
    Trainer's per-objective optax schedules do."""
    want, got, _, _ = _both(
        {"a": 10.0, "b": 10.0},
        dict(max_epochs=11, optimizer="sgd", learning_rate=0.1,
             lr_milestones=[3], round_robin=True),
        objectives=[lambda p: p["a"] ** 2, lambda p: p["b"] ** 2])
    _close(got, want, atol=1e-5)
    # a: 6 updates, 3 at 0.1 and 3 at 0.01; b: 5 updates
    np.testing.assert_allclose(got["a"], 10 * 0.8**3 * 0.98**3, rtol=1e-5)
    np.testing.assert_allclose(got["b"], 10 * 0.8**3 * 0.98**2, rtol=1e-5)


def test_round_robin_metrics_and_scoping_errors(tmp_path):
    _, tl = _loaders()
    tr = Trainer(max_epochs=3, optimizer="adam", round_robin=True,
                 run_dir=str(tmp_path), device="cpu")
    tr.fit(_Toy({"a": 1.0, "b": 1.0}, objectives=TWO), tl)
    with open(tmp_path / "metrics.csv") as f:
        header = f.readline().strip().split(",")
    assert {"loss_obj0", "loss_obj1"} <= set(header)
    assert all(isinstance(v, torch.Tensor) for v in tr._last_obj_loss)
    with pytest.raises(ValueError, match="no network parameter"):
        Trainer(round_robin=True, device="cpu").fit(
            _Toy({"a": 1.0, "b": 1.0}, objectives=TWO,
                 mask=[("a",), ("c",)]), tl)


# -- remat --------------------------------------------------------------------

def _remat_modules(kind, remat):
    n = 16
    if kind == "ibn":
        torch.manual_seed(0)
        return IBNPoisson2D(AE(1, 1, dims=2, n_downsample=2),
                            domain_size=n, remat=remat)
    ds = RectangleManufactured(domain_size=n)
    init = np.random.default_rng(0).random((n, n)).astype(np.float32)
    return Poisson2D(DirectField((n, n), init=init), ds, domain_size=n,
                     batch_size=1, loss_type=kind.split("_")[0],
                     fused_kernels=kind.endswith("fused"), remat=remat)


@pytest.mark.parametrize("kind", ["resmin", "resmin_fused", "energy_fused",
                                  "ibn"])
def test_remat_training_loss_identical(kind):
    """remat=True recomputes the forward in the backward pass: the loss
    and the gradients are bit-equal, also through the kernels' autograd
    functions (K1's, K3's) and the IBN loss."""
    if kind == "ibn":
        ds = SyntheticPointClouds(n_samples=2, n_points=40, domain_size=16)
        batch = tuple(torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
                      for k in range(3))
    else:
        batch = next(iter(NumpyLoader(RectangleManufactured(16), 1)))
    out = []
    for remat in (False, True):
        m = _remat_modules(kind, remat)
        loss = m.training_loss(batch)
        loss.backward()
        out.append((float(loss), [p.grad for p in m.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_remat_matches_jax():
    """The JAX test's module (resmin, 16^2, DirectField at ones): the
    port's remat loss and gradient against JAX's remat ones."""
    n = 16
    jds = JRectangleManufactured(domain_size=n)
    jnet = JDirectField((n, n))
    jm = JPoisson2D(jnet, jds, domain_size=n, batch_size=1,
                    loss_type="resmin", remat=True)
    jb = (jnp.asarray(jds[0][0])[None], jnp.asarray(jds[0][1])[None])
    lj, gj = jax.value_and_grad(jm.training_loss)(jnet.init(None), jb)
    tm = Poisson2D(DirectField((n, n)), RectangleManufactured(n),
                   domain_size=n, batch_size=1, loss_type="resmin",
                   remat=True)
    lt = tm.training_loss(tuple(torch.from_numpy(a)[None]
                                for a in tm.dataset[0]))
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=NS_RTOL)
    g = np.asarray(gj["field"])
    np.testing.assert_allclose(tm.network.field.grad.numpy(), g, rtol=0,
                               atol=NS_RTOL * np.abs(g).max())


# -- resume -------------------------------------------------------------------

def test_full_state_checkpoint_resume(tmp_path):
    """5 epochs, then resume_from for 5 more, land bit-equal on an unbroken
    10-epoch run, at step 10 and at JAX's parameter."""
    loss = lambda p: p["w"] ** 2  # noqa: E731
    kw = dict(optimizer="adam", learning_rate=0.1)
    want, got, tr, _ = _both({"w": 5.0}, dict(max_epochs=10, **kw), loss)
    _close(got, want)
    _, tl = _loaders()
    Trainer(max_epochs=5, run_dir=str(tmp_path), checkpoint=True,
            device="cpu", **kw).fit(_Toy({"w": 5.0}, loss), tl)
    tm = _Toy({"w": 5.0}, loss)
    st = Trainer(max_epochs=5, device="cpu", **kw).fit(
        tm, tl, resume_from=str(tmp_path / "state.ckpt"))
    assert _params(tm) == got and st.step == 10


@pytest.mark.parametrize("optimizer", ["adam", ["lbfgs", "adam"]])
def test_round_robin_resume_continues_rotation(tmp_path, optimizer):
    """3 batches an epoch and 2 objectives: the resumed run continues the
    rotation at objective 1 (not 0) and, with every optimizer's state
    restored (LBFGS's history included), lands bit-equal on an unbroken
    2-epoch run."""
    objs = [lambda p: (p["a"] - 0.0) ** 2 + p["b"] ** 2,
            lambda p: (p["a"] - 1.0) ** 2 + (p["b"] + 1.0) ** 2]
    kw = dict(optimizer=optimizer, round_robin=True, learning_rate=0.1)
    _, tl = _loaders(3)
    unbroken = _Toy({"a": 1.0, "b": 2.0}, objectives=objs)
    Trainer(max_epochs=2, device="cpu", **kw).fit(unbroken, tl)
    Trainer(max_epochs=1, run_dir=str(tmp_path), checkpoint=True,
            device="cpu", **kw).fit(_Toy({"a": 1.0, "b": 2.0},
                                         objectives=objs), tl)
    tm = _Toy({"a": 1.0, "b": 2.0}, objectives=objs)
    st = Trainer(max_epochs=1, device="cpu", **kw).fit(
        tm, tl, resume_from=str(tmp_path / "state.ckpt"))
    assert tm.seen[0] == 1, tm.seen
    assert _params(tm) == _params(unbroken) and st.step == 6


# -- nan_guard ------------------------------------------------------------------

def test_nan_guard_without_checkpoint_raises():
    """The JAX test's exploder: exp(w^2) overflows after a 1e30 step, and
    without a state.ckpt nan_guard stops with a clear error."""
    _, tl = _loaders()
    with pytest.raises(RuntimeError, match="nan_guard: non-finite loss"):
        Trainer(max_epochs=20, optimizer="sgd", learning_rate=1e30,
                nan_guard=True, device="cpu").fit(
            _Toy({"w": 2.0}, lambda p: torch.exp(p["w"] ** 2)), tl)


class _Flaky(_Toy):
    """w^2, but the loss is NaN at the calls listed in `bad`."""

    def __init__(self, bad):
        super().__init__({"w": 1.0}, lambda p: p["w"] ** 2)
        self.bad, self.calls = set(bad), 0

    def training_loss(self, batch):
        self.calls += 1
        loss = self.network["w"] ** 2
        return loss * float("nan") if self.calls in self.bad else loss


def test_nan_guard_restores_and_backs_off(tmp_path):
    """SGD lr 0.1 on w^2 scales w by 0.8 a step. The third step's loss is
    NaN: the epoch is dropped, state.ckpt (w = 0.64 after two steps) is
    restored, and the learning rate is halved from then on (w x 0.9 a
    step), so five epochs end at 0.64 x 0.9^2."""
    m = _Flaky(bad={3})
    tr = Trainer(max_epochs=5, optimizer="sgd", learning_rate=0.1,
                 nan_guard=True, run_dir=str(tmp_path), checkpoint=True,
                 device="cpu")
    st = tr.fit(m, _loaders()[1])
    np.testing.assert_allclose(float(m.network["w"].detach()), 0.64 * 0.9**2,
                               rtol=1e-6)
    assert tr._nan_restores == 1 and st.step == 4
    assert st.optimizer.param_groups[0]["lr"] == 0.1   # the base rate kept


def test_nan_guard_aborts_after_three_restores(tmp_path):
    m = _Flaky(bad=range(2, 100))
    tr = Trainer(max_epochs=10, optimizer="adam", nan_guard=True,
                 run_dir=str(tmp_path), checkpoint=True, device="cpu")
    with pytest.raises(RuntimeError, match="diverged repeatedly"):
        tr.fit(m, _loaders()[1])
    assert tr._nan_restores == 4


# -- profiler, config, loggers -------------------------------------------------

def test_profiler_trace_written(tmp_path):
    d = tmp_path / "trace"
    tr = Trainer(max_epochs=2, optimizer="sgd", learning_rate=0.1,
                 profile_dir=str(d), device="cpu")
    tr.fit(_Toy({"w": 1.0}, lambda p: p["w"] ** 2), _loaders()[1])
    assert os.listdir(d) == [os.path.basename(tr.trace_path)]
    with open(tr.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "Optimizer.step#SGD.step" in names or any(
        "sgd" in str(n).lower() for n in names)


def test_inp_config_parser(tmp_path):
    p = tmp_path / "conf.inp"
    p.write_text('domain_size = 32;\nmax_epochs = 500;\nLR = 0.001;\n'
                 'loss_type = "resmin";  # comment\noptimizer = "lbfgs";\n'
                 'nu = 0.01;\n')
    cfg, extras = config_from_inp(str(p), return_extras=True)
    assert cfg.domain_size == 32 and cfg.max_epochs == 500
    assert abs(cfg.learning_rate - 1e-3) < 1e-12
    assert cfg.loss_type == "resmin" and cfg.optimizer == "lbfgs"
    jcfg, jextras = jconfig_from_inp(str(p), return_extras=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert extras == jextras == {"nu": 0.01}


def test_config_args_and_json_round_trip(tmp_path):
    argv = ["--no-checkpoint", "--lr-milestones", "10", "15",
            "--domain-size", "33"]
    cfg = config_from_args(add_config_args(argparse.ArgumentParser())
                           .parse_args(argv))
    jcfg = jconfig_from_args(jadd_config_args(argparse.ArgumentParser())
                             .parse_args(argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.checkpoint is False and cfg.lr_milestones == (10, 15)
    cfg.to_json(str(tmp_path / "c.json"))
    assert RunConfig.from_json(str(tmp_path / "c.json")) == cfg
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(JRunConfig())


def test_tensorboard_logger(tmp_path, monkeypatch):
    """Scalars as events where tensorboard is installed; a clear
    ImportError where it is not."""
    try:
        import tensorboard  # noqa: F401
        have = True
    except ImportError:
        have = False
    if have:
        lg = TensorBoardLogger(str(tmp_path))
        lg.log({"epoch": 0, "loss": 1.0, "name": "x"})
        lg.close()
        assert any(f.startswith("events.") for f in os.listdir(tmp_path))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard package"):
        TensorBoardLogger(str(tmp_path))


def test_optimizer_factory_equals_the_named_optimizer():
    loss = lambda p: (p["w"] - 1.0) ** 2  # noqa: E731
    _, tl = _loaders()
    a, b = _Toy({"w": 5.0}, loss), _Toy({"w": 5.0}, loss)
    Trainer(max_epochs=7, optimizer="sgd", learning_rate=0.1,
            device="cpu").fit(a, tl)
    Trainer(max_epochs=7, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1),
            device="cpu").fit(b, tl)
    assert _params(a) == _params(b) != {"w": 5.0}
    with pytest.raises(TypeError):
        Trainer(optimizer=lambda ps: None, device="cpu").fit(
            _Toy({"w": 5.0}, loss), tl)


# -- OptimizerSwitch ------------------------------------------------------------

def test_optimizer_switch_adam_to_lbfgs(tmp_path):
    """Adam -> LBFGS at epoch 3: the switch applies, LBFGS solves the
    quadratic, Adam alone cannot; state.ckpt is written again at the
    switch, with the new optimizer, and a resume from it runs on LBFGS."""
    loss = lambda p: p["w"] ** 2  # noqa: E731
    _, tl = _loaders()
    tr = Trainer(max_epochs=10, optimizer="adam", learning_rate=0.01,
                 lbfgs_max_iter=5, device="cpu",
                 callbacks=[OptimizerSwitch(epoch=3, optimizer="lbfgs",
                                            lbfgs_max_iter=10)])
    m = _Toy({"w": 10.0}, loss)
    tr.fit(m, tl)
    assert tr.optimizer_spec == "lbfgs" and tr.lbfgs_max_iter == 10
    assert abs(float(m.network["w"].detach())) < 1e-3
    m2 = _Toy({"w": 10.0}, loss)
    Trainer(max_epochs=10, optimizer="adam", learning_rate=0.01,
            device="cpu").fit(m2, tl)
    assert abs(float(m2.network["w"].detach())) > 1.0

    tr = Trainer(max_epochs=3, optimizer="adam", learning_rate=0.01,
                 run_dir=str(tmp_path), checkpoint=True, device="cpu",
                 callbacks=[OptimizerSwitch(3, "lbfgs", lbfgs_max_iter=7)])
    tr.fit(_Toy({"w": 10.0}, loss), tl)
    ck = load_state(str(tmp_path / "state.ckpt"))
    assert ck["optimizer_spec"] == "lbfgs" and ck["epoch"] == 2
    assert ck["opt_state"]["state"] == {}          # fresh LBFGS state
    tr2 = Trainer(max_epochs=2, optimizer="adam", device="cpu")
    st = tr2.fit(_Toy({"w": 10.0}, loss), tl,
                 resume_from=str(tmp_path / "state.ckpt"))
    assert isinstance(st.optimizer, ZoomLBFGS)
    assert tr2.lbfgs_max_iter == 7 and st.step == 5


def test_optimizer_switch_round_robin_list():
    """Round-robin switch to [LBFGS, Adam] at epoch 5: the LBFGS objective
    converges exactly in both packages, and the Adam one, restarted from a
    fresh state at the switch in both, ends at JAX's value."""
    want, got, tr, _ = _both(
        {"a": 1.0, "b": 1.0}, dict(max_epochs=30, optimizer="adam",
                                   learning_rate=0.05, round_robin=True,
                                   lbfgs_max_iter=5),
        objectives=TWO, lr=0.05, n=2,
        callbacks=lambda jax_side: [
            (JOptimizerSwitch if jax_side else OptimizerSwitch)(
                5, ["lbfgs", "adam"])])
    for p in (want, got):
        assert abs(p["a"] - 3.0) < 1e-3 and p["b"] < -0.2
    assert abs(got["b"] - want["b"]) <= PARAM_ATOL
    assert isinstance(tr.state.optimizer[0], ZoomLBFGS)
    assert isinstance(tr.state.optimizer[1], torch.optim.Adam)


# -- the Navier-Stokes objective protocol ---------------------------------------

def _ns_pair(n, fused, init_seed=0):
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    kw = dict(domain_size=n, batch_size=1, Re=100.0, u_bc=u_bc, v_bc=v_bc,
              p_bc=p_bc, loss_norm="squared")
    fields = np.random.default_rng(init_seed).random((3, n, n)) \
        .astype(np.float32)
    jds = JNSLDCDataset(domain_sizes=(n, n), Re=100.0)
    jm = JNavierStokes(JDirectField((n, n), n_fields=3), jds, **kw)
    tm = NavierStokes(DirectField((n, n), n_fields=3),
                      NSLDCDataset(domain_sizes=(n, n), Re=100.0),
                      fused_kernels=fused, **kw)
    params = {f"field_{i}": fields[i] for i in range(3)}
    tm.network.load_state_dict(params_from_jax(params))
    return jm, tm, params


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("norm", ["squared", "frobenius"])
def test_ns_objectives_match_jax(fused, norm):
    """objective_loss(idx) for each field residual and its gradient, and
    objective_param_mask, against the JAX package's at 17^2 (the fused
    path runs K6's plain version on the CPU)."""
    n = 17
    jm, tm, params = _ns_pair(n, fused)
    jm.loss_norm = tm.loss_norm = norm
    jb = tuple(jnp.asarray(a)[None] for a in jm.dataset[0])
    tb = tuple(torch.from_numpy(a)[None] for a in tm.dataset[0])
    jp = jax.tree.map(jnp.asarray, params)
    assert tm.num_objectives == jm.num_objectives == 3
    for idx in range(3):
        lj, gj = jax.value_and_grad(
            lambda p: jm.objective_loss(idx, p, jb))(jp)
        tm.zero_grad()
        lt = tm.objective_loss(idx, tb)
        lt.backward()
        np.testing.assert_allclose(float(lt), float(lj), rtol=NS_RTOL)
        scale = max(float(np.abs(np.asarray(g)).max()) for g in gj.values())
        for k, g in gj.items():
            np.testing.assert_allclose(
                getattr(tm.network, k).grad.numpy(), np.asarray(g), rtol=0,
                atol=NS_RTOL * scale, err_msg=k)
        want = jm.objective_param_mask(idx, jp)
        assert tm.objective_param_mask(idx) == tuple(
            k for k, v in want.items() if v)


def test_ns_objective_mask_is_none_for_shared_networks():
    from diffnet_tpu_torch.models import MultiOutUNet

    n = 16
    m = NavierStokes(MultiOutUNet(in_channels=5, base_filters=2),
                     NSLDCDataset(domain_sizes=(n, n), Re=100.0),
                     domain_size=n, Re=100.0)
    assert m.objective_param_mask(0) is None


def test_ns_round_robin_fit_matches_jax():
    """Six round-robin Adam epochs (one objective step each) on the 17^2
    cavity from seeded fields, each objective scoped to its field: the
    fields within 1e-4 of the JAX Trainer's."""
    n = 17
    jm, tm, params = _ns_pair(n, fused=True, init_seed=1)
    kw = dict(max_epochs=6, optimizer="adam", learning_rate=1e-3,
              round_robin=True)
    jds = JNSLDCDataset(domain_sizes=(n, n), Re=100.0)
    jds.n_samples = 1
    tm.dataset.n_samples = 1
    jst = JTrainer(**kw).fit(jm, JNumpyLoader(jds, 1),
                             params=jax.tree.map(jnp.asarray, params))
    Trainer(device="cpu", **kw).fit(tm, NumpyLoader(tm.dataset, 1))
    for k, v in jst.params.items():
        np.testing.assert_allclose(getattr(tm.network, k).detach().numpy(),
                                   np.asarray(v), rtol=0, atol=PARAM_ATOL)


class _ObjLosses:
    """Each epoch's loss_obj{i} metrics (a JAX or a port callback)."""

    def __init__(self):
        self.rows = []

    def on_train_start(self, *args):
        pass

    def on_train_end(self, *args):
        pass

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.rows.append([metrics.get(f"loss_obj{i}", np.nan)
                          for i in range(3)])


def test_fpc_round_robin_shared_network_matches_jax():
    """examples/ns_fpc_parametric.py's round robin on a non-square grid
    (32 x 64 nodes, four synthetic obstacles, a shared MultiOutUNet, so
    every objective updates every parameter): K6 takes square grids only,
    so this path stays unfused and is held here, on the CPU. 3 SGD epochs
    of 2 batches (objectives 0, 1, 2, 0, 1, 2) on the JAX Trainer's
    batches: each objective's last loss after every epoch within 1e-3
    relative of JAX's (the two-filter network's norms make it steep in its
    parameters: six steps part the losses by up to 4e-4). The fused module
    raises."""
    from diffnet_tpu.data.flow import (
        FlowPastObjectEnsemble as JFlowPastObjectEnsemble)
    from diffnet_tpu.models.networks import MultiOutUNet as JMultiOutUNet
    from diffnet_tpu_torch.data import (FlowPastObjectEnsemble,
                                        synthetic_obstacles)
    from diffnet_tpu_torch.models import MultiOutUNet

    from .test_torch_networks import flax_params

    ny, nx, lengths = 32, 64, (4.0, 1.0)
    chis = synthetic_obstacles(4, (ny, nx), lengths, seed=0)
    jds = JFlowPastObjectEnsemble(chis, domain_lengths=lengths, Re=100)
    tds = FlowPastObjectEnsemble(chis, domain_lengths=lengths, Re=100)
    jnet = JMultiOutUNet(num_outputs=3, out_channels=1, base_filters=2)
    params = jax.tree.map(np.asarray, flax_params(
        jnet, np.zeros((1, ny, nx, 6), np.float32)))
    tnet = MultiOutUNet(in_channels=6, base_filters=2)
    tnet.load_state_dict(params_from_jax(params))
    kw = dict(domain_lengths=lengths, domain_sizes=(nx, ny), batch_size=2,
              Re=100.0, loss_norm="squared")
    jm = JNavierStokes(jnet, jds, u_bc=jds.u_bc, **kw)
    tm = NavierStokes(tnet, tds, u_bc=tds.u_bc, **kw)
    assert tm.objective_param_mask(0) is None
    tkw = dict(max_epochs=3, optimizer="sgd", learning_rate=1e-3,
               round_robin=True)
    jrec, trec = _ObjLosses(), _ObjLosses()
    JTrainer(callbacks=[jrec], **tkw).fit(
        jm, JNumpyLoader(jds, 2, shuffle=True),
        params=jax.tree.map(jnp.asarray, params))
    loader = NumpyLoader(tds, 2, shuffle=True)
    next(iter(loader))   # the JAX Trainer draws one batch before training
    Trainer(callbacks=[trec], device="cpu", **tkw).fit(tm, loader)
    np.testing.assert_allclose(trec.rows, jrec.rows, rtol=1e-3)
    assert np.isnan(trec.rows[0][2]) and np.isfinite(trec.rows[-1]).all()
    fused = NavierStokes(tnet, tds, u_bc=tds.u_bc, fused_kernels=True, **kw)
    with pytest.raises(ValueError):
        fused.objective_loss(0, next(iter(NumpyLoader(tds, 2))))


# -- pretraining ----------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [4, 16])
def test_pretrain_autoencoder_matches_jax(tmp_path, batch_size):
    """2 epochs of MSE reconstruction from the same flax initial weights on
    10 random 16^2 images (batches of 4 shuffled with the last partial one
    kept, or one batch of all 10): the trained network's reconstructions
    within 1e-4 of the largest, and the saved state dict loads back."""
    images = np.random.default_rng(0).random((10, 16, 16)).astype(np.float32)
    jnet = JAE(out_channels=1, dims=2, n_downsample=2)
    jparams = jpretrain_autoencoder(jnet, JArrayImageDataset(images),
                                    epochs=2, batch_size=batch_size,
                                    learning_rate=1e-3, seed=3)
    init = jnet.init(jax.random.key(3), jnp.zeros((1, 16, 16, 1)))
    tnet = AE(1, 1, dims=2, n_downsample=2)
    tnet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, init)))
    path = str(tmp_path / "ae" / "w.pt")
    got = pretrain_autoencoder(tnet, ArrayImageDataset(images), epochs=2,
                               batch_size=batch_size, learning_rate=1e-3,
                               seed=3, save_path=path, device="cpu")
    x = images[..., None]
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=PARAM_ATOL * np.abs(want).max())
    saved = torch.load(path, weights_only=True)
    assert all(torch.equal(saved[k], got[k]) for k in got)
