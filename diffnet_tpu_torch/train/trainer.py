"""Explicit training loop (port of ``diffnet_tpu/train/trainer.py``).

``Trainer.fit(module)`` moves the module to the trainer's device, builds a
loader from ``module.dataset`` when none is given, and runs epochs of
optimizer steps on ``module.training_loss``:

  * optimizers: ``"adam"``, ``"sgd"`` and ``"lbfgs"``. LBFGS is
    ``torch.optim.LBFGS(lr=1, max_iter=lbfgs_max_iter,
    line_search_fn="strong_wolfe")`` stepped once per batch; its line
    search is not optax's zoom search, so it agrees with the JAX Trainer in
    the solution reached, not step by step;
  * ``lr_milestones``: the learning rate times ``lr_gamma`` at each
    milestone epoch (torch's ``MultiStepLR``, stepped once an optimizer step
    with the milestones in steps, as optax's ``piecewise_constant_schedule``
    is in the JAX Trainer);
  * versioned run directories ``save_dir/name/version_N``
    (:func:`make_run_dir`);
  * CSV metrics per epoch (:class:`CSVLogger`);
  * checkpoints ``last.ckpt``, ``best.ckpt`` (network parameters) and
    ``state.ckpt`` (parameters, optimizer state and step);
  * callbacks with ``on_train_start`` / ``on_epoch_end`` / ``on_train_end``
    hooks, and :class:`EarlyStopping`.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ..data.loader import NumpyLoader
from ..utils.device import resolve_device

__all__ = ["TrainState", "Trainer", "Callback", "CSVLogger", "EarlyStopping",
           "make_run_dir", "save_params", "load_params", "save_state",
           "load_state"]


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]   # the network's state dict
    optimizer: torch.optim.Optimizer
    step: int


def make_run_dir(save_dir: str, name: str) -> str:
    """Create ``save_dir/name/version_N`` with the next free N."""
    base = os.path.join(save_dir, name)
    os.makedirs(base, exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(base, f"version_{n}")):
        n += 1
    run = os.path.join(base, f"version_{n}")
    os.makedirs(run)
    return run


def save_params(params: dict[str, torch.Tensor], path: str) -> None:
    torch.save(params, path)


def load_params(path: str, map_location=None) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location=map_location, weights_only=True)


def save_state(state: TrainState, path: str) -> None:
    """Full training state (parameters, optimizer state, step)."""
    torch.save({"params": state.params,
                "opt_state": state.optimizer.state_dict(),
                "step": state.step}, path)


def load_state(path: str, map_location=None) -> dict[str, Any]:
    """``{"params", "opt_state", "step"}`` as written by :func:`save_state`."""
    return torch.load(path, map_location=map_location, weights_only=True)


class Callback:
    def on_train_start(self, trainer, module, state):  # noqa: D102
        pass

    def on_epoch_end(self, trainer, module, state, epoch: int,
                     metrics: dict):  # noqa: D102
        pass

    def on_train_end(self, trainer, module, state):  # noqa: D102
        pass


class EarlyStopping(Callback):
    """Stop when `monitor` has not improved by `min_delta` for `patience`
    epochs."""

    def __init__(self, monitor="loss", min_delta=1e-8, patience=10,
                 mode="min"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = np.inf
        self.bad_epochs = 0

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        val = self.sign * metrics.get(self.monitor, np.inf)
        if val < self.best - self.min_delta:
            self.best = val
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                trainer.should_stop = True


class CSVLogger:
    """One row of metrics per call; a metric that first appears later
    extends the header and the file is rewritten."""

    def __init__(self, run_dir: str, filename: str = "metrics.csv"):
        self.path = os.path.join(run_dir, filename)
        self._fieldnames: list[str] | None = None

    def log(self, metrics: dict):
        new_file = self._fieldnames is None
        if new_file:
            self._fieldnames = list(metrics.keys())
        new_keys = [k for k in metrics if k not in self._fieldnames]
        if new_keys and not new_file:
            self._fieldnames += new_keys
            with open(self.path, newline="") as f:
                rows = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames,
                                   restval="")
                w.writeheader()
                w.writerows(rows)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, restval="")
            if new_file:
                w.writeheader()
            w.writerow(metrics)


def _make_optimizer(name: str, params, learning_rate: float,
                    lbfgs_max_iter: int) -> torch.optim.Optimizer:
    name = str(name).lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name == "lbfgs":
        # torch's default tolerances (1e-7 on the gradient, 1e-9 on the
        # change) are absolute and end a step early once a residual loss
        # falls below them, and its default max_eval (1.25 max_iter) ends
        # it when line searches take a second evaluation; the JAX Trainer
        # always runs max_iter iterations. 25 evaluations an iteration is
        # the cap torch puts on one line search.
        return torch.optim.LBFGS(params, lr=1.0, max_iter=lbfgs_max_iter,
                                 max_eval=25 * lbfgs_max_iter,
                                 tolerance_grad=0.0, tolerance_change=0.0,
                                 line_search_fn="strong_wolfe")
    raise ValueError(f"unknown optimizer {name!r}")


class Trainer:
    """Explicit training loop.

    Parameters
    ----------
    max_epochs : int
    optimizer : 'adam' | 'sgd' | 'lbfgs'
    learning_rate : for adam/sgd; defaults to ``module.learning_rate``
    lbfgs_max_iter : LBFGS iterations per step
    callbacks, run_dir, log_every : observability (CSV in `run_dir`)
    checkpoint : save last/best/state checkpoints to `run_dir`
    fast_dev_run : one batch of one epoch
    seed : loader shuffle seed
    lr_milestones, lr_gamma : epochs at which adam's or sgd's learning rate
        is multiplied by `lr_gamma`
    device : where the module and the batches go (the card by default);
        'cuda' raises when no GPU is available
    """

    def __init__(self, max_epochs: int = 1, optimizer: str = "adam",
                 learning_rate: float | None = None, lbfgs_max_iter: int = 5,
                 callbacks: Sequence[Callback] = (),
                 run_dir: str | None = None, log_every: int = 1,
                 checkpoint: bool = False, fast_dev_run: bool = False,
                 seed: int = 42, device: str | torch.device = "cuda",
                 lr_milestones: Sequence[int] | None = None,
                 lr_gamma: float = 0.1):
        self.max_epochs = 1 if fast_dev_run else max_epochs
        self.optimizer_spec = optimizer
        if lr_milestones and str(optimizer).lower() == "lbfgs":
            raise ValueError("lr_milestones apply to adam and sgd; lbfgs "
                             "takes unit steps from its line search")
        self.lr_milestones = lr_milestones
        self.lr_gamma = lr_gamma
        self.learning_rate = learning_rate
        self.lbfgs_max_iter = lbfgs_max_iter
        self.callbacks = list(callbacks)
        self.run_dir = run_dir
        self.logger = CSVLogger(run_dir) if run_dir else None
        self.log_every = log_every
        self.checkpoint = checkpoint and run_dir is not None
        self.fast_dev_run = fast_dev_run
        self.seed = seed
        self.device = resolve_device(device, "Trainer")
        self.should_stop = False
        self.state: TrainState | None = None
        self.epoch_times: list[float] = []
        self.step_losses: list[float] = []   # the last epoch's, per step

    def _step_fn(self, module, opt, sched=None):
        if isinstance(opt, torch.optim.LBFGS):
            def step(batch):
                # opt.step returns the loss before its first update; the
                # last evaluation is at the parameters the step leaves
                # (torch's line search ends on its last point unless its
                # bracket fails)
                last = []

                def closure():
                    opt.zero_grad(set_to_none=True)
                    loss = module.training_loss(batch)
                    loss.backward()
                    last[:] = [loss.detach()]
                    return loss
                opt.step(closure)
                return last[0]
            return step

        def step(batch):
            opt.zero_grad(set_to_none=True)
            loss = module.training_loss(batch)
            loss.backward()
            opt.step()
            if sched is not None:
                sched.step()
            return loss
        return step

    def fit(self, module, dataloader=None, params=None,
            val_dataloader=None) -> TrainState:
        """Train `module`. Without `dataloader`, one is built from
        ``module.dataset``. `params` (a state dict of ``module.network``)
        replaces the network's parameters first. `val_dataloader` adds a
        per-epoch ``val_loss`` metric."""
        module.to(self.device)
        if dataloader is None:
            if module.dataset is None:
                raise ValueError(
                    "no dataloader given and module.dataset is None")
            dataloader = NumpyLoader(module.dataset,
                                     batch_size=module.batch_size,
                                     shuffle=True, seed=self.seed,
                                     device=self.device)
        if len(dataloader) == 0:
            raise ValueError(
                "dataloader yields zero batches (dataset smaller than "
                "batch_size with drop_last=True?) - lower batch_size or use "
                "NumpyLoader(..., drop_last=False)")
        if params is not None:
            module.network.load_state_dict(params)
        lr = self.learning_rate or getattr(module, "learning_rate", 3e-4)
        opt = _make_optimizer(self.optimizer_spec, module.parameters(), lr,
                              self.lbfgs_max_iter)
        sched = None
        if self.lr_milestones:
            spe = len(dataloader)
            sched = torch.optim.lr_scheduler.MultiStepLR(
                opt, [int(m) * spe for m in self.lr_milestones],
                gamma=self.lr_gamma)
        step_fn = self._step_fn(module, opt, sched)
        n_steps = 0

        def state():
            return TrainState(module.network.state_dict(), opt, n_steps)

        for cb in self.callbacks:
            cb.on_train_start(self, module, state())

        best = np.inf
        for epoch in range(self.max_epochs):
            t0 = time.perf_counter()
            losses = []
            module.train()
            for batch in dataloader:
                batch = tuple(t.to(self.device) for t in batch)
                losses.append(step_fn(batch).detach())
                n_steps += 1
                if self.fast_dev_run:
                    break
            losses = torch.stack(losses)
            self.step_losses = losses.tolist()
            epoch_loss = float(losses.mean())
            dt = time.perf_counter() - t0
            self.epoch_times.append(dt)
            metrics = {"epoch": epoch, "loss": epoch_loss,
                       "PDE_loss": epoch_loss, "time_sec": dt}
            if val_dataloader is not None:
                with torch.no_grad():
                    vlosses = [module.training_loss(
                        tuple(t.to(self.device) for t in b))
                        for b in val_dataloader]
                metrics["val_loss"] = float(torch.stack(vlosses).mean())
            if self.logger and epoch % self.log_every == 0:
                self.logger.log(metrics)
            self.state = state()
            if self.checkpoint:
                save_params(self.state.params,
                            os.path.join(self.run_dir, "last.ckpt"))
                save_state(self.state,
                           os.path.join(self.run_dir, "state.ckpt"))
                if epoch_loss < best:
                    best = epoch_loss
                    save_params(self.state.params,
                                os.path.join(self.run_dir, "best.ckpt"))
            for cb in self.callbacks:
                cb.on_epoch_end(self, module, self.state, epoch, metrics)
            if self.should_stop:
                break

        self.state = state()
        for cb in self.callbacks:
            cb.on_train_end(self, module, self.state)
        return self.state
