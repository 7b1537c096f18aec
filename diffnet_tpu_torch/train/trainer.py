"""Explicit training loop (port of ``diffnet_tpu/train/trainer.py``).

``Trainer.fit(module)`` moves the module to the trainer's device, builds a
loader from ``module.dataset`` when none is given, and runs epochs of
optimizer steps on ``module.training_loss``:

  * optimizers: ``"adam"``, ``"sgd"``, ``"lbfgs"``, or a callable
    ``params -> torch.optim.Optimizer`` (the counterpart of an optax
    transform). ``"lbfgs"`` is ``optax.lbfgs()``, the JAX Trainer's:
    :class:`~diffnet_tpu_torch.train.lbfgs.ZoomLBFGS`, ``lbfgs_max_iter``
    of its updates a batch, the loss logged the value at the start of the
    last one; the first update of a batch starts from the value and
    gradient the previous batch's last update accepted (JAX's
    ``value_and_grad_from_state``), so it follows the JAX Trainer step by
    step. On the card, without a process mesh, each evaluation of the loss
    and its gradients (up to 20 an update, in the line search) is a replay
    of one CUDA graph a batch shape (:class:`_GraphedLoss`; a loss that
    reads the host runs eagerly, with a warning);
  * ``lr_milestones``: the learning rate times ``lr_gamma`` at each
    milestone epoch (torch's ``MultiStepLR``, stepped once an optimizer step
    with the milestones in steps, as optax's ``piecewise_constant_schedule``
    is in the JAX Trainer);
  * ``round_robin``: one optimizer per objective of a module exposing
    ``num_objectives`` and ``objective_loss(idx, batch)``, each over the
    parameters ``objective_param_mask(idx)`` names (all when None), the
    objective rotating once a batch; ``optimizer`` may be a list with one
    spec per objective, and the metrics carry ``loss_obj{i}``. An LBFGS
    objective runs, as JAX's, over all of the module's parameters: only
    its own get gradients, every turn's first update is evaluated anew,
    and after every update the others are put back to their values at
    the turn's start (its line search's trials move them, as JAX's do:
    the memory's pairs hold the other objectives' moves);
  * :class:`OptimizerSwitch` / :meth:`Trainer.request_optimizer_switch`:
    a new optimizer between epochs, the parameters kept, its state fresh;
  * ``resume_from``: an exact resume from ``state.ckpt`` (parameters,
    optimizer and scheduler states, step, objective rotation, epoch);
  * ``nan_guard``: on a non-finite epoch loss, restore ``state.ckpt`` and
    halve Adam's and SGD's learning rate for each restore so far (LBFGS
    restores only); abort after three restores;
  * ``profile_dir``: the fit under ``torch.profiler`` (CPU and CUDA
    activities), written there as a Chrome trace;
  * ``steps_per_call=K``: Adam's and SGD's steps in chunks of K batches
    (JAX's ``lax.scan`` of K steps): a batch of another shape flushes the
    pending chunk first, and the end of an epoch flushes the remainder;
    one loss a step. On the card, without a process mesh, each chunk
    shape is one CUDA graph of K forward, backward and optimizer steps
    (:class:`_GraphedChunks`: the batches copied into static ``[K, ...]``
    buffers, Adam built ``capturable`` and SGD ``fused``, their learning
    rate a device tensor that the nan_guard scale and the milestones set
    between replays). On the CPU, and over a process mesh (gloo's
    all-reduce is a host operation and cannot be captured), the K steps
    run eagerly as K single steps. LBFGS, ``round_robin`` and
    ``fast_dev_run`` take single steps whatever K is, as in JAX;
  * versioned run directories ``save_dir/name/version_N``
    (:func:`make_run_dir`), CSV metrics per epoch (:class:`CSVLogger`;
    :class:`TensorBoardLogger` when ``tensorboard`` is installed);
  * checkpoints ``last.ckpt``, ``best.ckpt`` (network parameters) and
    ``state.ckpt`` (the full training state);
  * callbacks with ``on_train_start`` / ``on_epoch_end`` / ``on_train_end``
    hooks, and :class:`EarlyStopping`;
  * data-parallel training: a loader on a process mesh
    (``NumpyLoader(..., mesh=)``, one process a rank) hands each rank its
    rows of every global batch, and ``fit`` then starts every rank from the
    first rank's parameters and, after each backward, all-reduces the
    gradients and the loss over the mesh's 'data' axis as
    ``module.batch_reduction`` says (a sum for a loss that sums over the
    batch, a mean for one that averages). For a loss that does not split
    over the batch (a root of a sum over it: ``batch_reduction =
    "global"``) the Trainer sums the module's ``training_parts`` over
    'data' with the differentiable all-reduce and takes
    ``module.loss_from_parts`` of the sums, so every rank computes the
    global batch's loss; it then averages the gradients only (each rank's
    backward carries the all-reduce's ``size('data')`` share, see
    ``parallel.all_reduce_sum``) and keeps the loss as it is. Validation
    over a data mesh computes its losses the same way. Every rank takes
    the step the global batch gives,
    LBFGS's line search and curvature pairs included,
    and ``nan_guard``, the switch and the callbacks see the same losses on
    every rank. Only the mesh's first rank writes logs and checkpoints
    (give every rank the same ``run_dir``). A loader that also splits its
    batches over the mesh's 'space' axis (``NumpyLoader(mesh=,
    space_axis=)``) needs a module built on the same mesh, whose loss is
    then the global one on every space rank (the IBN energies over a
    split ``UNet``); the Trainer averages the gradients over 'space'
    first, so that every rank's loss and gradients are one process's on
    the global batch.
"""

from __future__ import annotations

import csv
import math
import os
import time
import warnings
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..data.loader import NumpyLoader
from ..parallel.mesh import all_reduce_sum, replicate, spatial_mesh
from ..utils.device import resolve_device
from .krylov import capture_graph, replay_graph
from .lbfgs import ZoomLBFGS

__all__ = ["TrainState", "Trainer", "Callback", "CSVLogger",
           "TensorBoardLogger", "EarlyStopping", "OptimizerSwitch",
           "make_run_dir", "save_params", "load_params", "save_state",
           "load_state"]

NAN_GUARD_RESTORES = 3   # restores before nan_guard gives up


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]   # the network's state dict
    optimizer: Any    # an Optimizer; in round-robin mode one per objective
    step: int
    schedulers: Any = None   # the lr scheduler(s) beside `optimizer`


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


def _state_dicts(objs):
    """The state dict of an optimizer or scheduler, a list of them for a
    tuple (None stays None)."""
    if isinstance(objs, (tuple, list)):
        return [None if o is None else o.state_dict() for o in objs]
    return None if objs is None else objs.state_dict()


def save_state(state: TrainState, path: str, **extra) -> None:
    """Full training state: parameters, optimizer and scheduler states,
    step, and the `extra` entries (the Trainer adds the epoch, the
    objective rotation and the optimizer spec)."""
    torch.save({"params": state.params,
                "opt_state": _state_dicts(state.optimizer),
                "sched_state": _state_dicts(state.schedulers),
                "step": state.step, **extra}, path)


def load_state(path: str, map_location=None) -> dict[str, Any]:
    """``{"params", "opt_state", "sched_state", "step", ...}`` as written
    by :func:`save_state`."""
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


class OptimizerSwitch(Callback):
    """Switch the optimizer at epoch `epoch` (the reference's Adam -> LBFGS
    pattern). `optimizer` is anything the Trainer takes, in round-robin
    mode also a list with one spec per objective. Training resumes on the
    new optimizer exactly at `epoch`: the parameters carry over, its state
    starts fresh."""

    def __init__(self, epoch: int, optimizer="lbfgs",
                 learning_rate: float | None = None,
                 lbfgs_max_iter: int | None = None):
        self.switch_epoch = int(epoch)
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.lbfgs_max_iter = lbfgs_max_iter

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        if epoch + 1 == self.switch_epoch:
            trainer.request_optimizer_switch(
                self.optimizer, learning_rate=self.learning_rate,
                lbfgs_max_iter=self.lbfgs_max_iter)


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


class TensorBoardLogger:
    """Scalar metrics as TensorBoard events in `run_dir`, beside the CSV:
    ``log(metrics)`` writes every number but ``epoch`` at step ``epoch``.
    Needs the ``tensorboard`` package."""

    def __init__(self, run_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "TensorBoardLogger needs the tensorboard package "
                "(torch.utils.tensorboard imports it); install it or use "
                "CSVLogger") from e
        self.writer = SummaryWriter(run_dir)

    def log(self, metrics: dict):
        step = int(metrics.get("epoch", 0))
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and k != "epoch":
                self.writer.add_scalar(k, v, step)

    def close(self):
        self.writer.close()


def _make_optimizer(spec, params: list, learning_rate: float,
                    graphed: bool = False) -> torch.optim.Optimizer:
    """The optimizer of `spec`. `graphed`: Adam and SGD for a CUDA graph,
    their learning rate a device tensor (Adam ``capturable``, SGD
    ``fused``: the updates that read a tensor learning rate on the
    card)."""
    if callable(spec):
        opt = spec(params)
        if not isinstance(opt, torch.optim.Optimizer):
            raise TypeError("an optimizer factory must return a "
                            f"torch.optim.Optimizer, got {type(opt)}")
        return opt
    name = str(spec).lower()
    if graphed and name in ("adam", "sgd"):
        lr = torch.tensor(learning_rate, device=params[0].device)
        if name == "adam":
            return torch.optim.Adam(params, lr=lr, capturable=True)
        return torch.optim.SGD(params, lr=lr, fused=True)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name == "lbfgs":
        # optax.lbfgs(), the JAX Trainer's; a step runs lbfgs_max_iter of
        # its updates (Trainer._step_fn)
        return ZoomLBFGS(params)
    raise ValueError(f"unknown optimizer {spec!r}")


def _spec_key(spec):
    """An optimizer spec as checkpoints keep it: its lowercase name, a list
    of names, or None for a factory (which cannot be saved)."""
    if isinstance(spec, (list, tuple)):
        keys = [_spec_key(s) for s in spec]
        return None if None in keys else keys
    return None if callable(spec) else str(spec).lower()


def _data_mesh(loader, module):
    """``(mesh, module.batch_reduction, split)`` for a loader on a mesh
    whose 'data' axis has more than one rank or that splits its batches
    over a 'space' axis of more than one rank (`split`), else ``(None,
    None, False)``."""
    mesh = getattr(loader, "mesh", None)
    split = (spatial_mesh(mesh) is not None
             and getattr(loader, "space_axis", None) is not None)
    if split and getattr(module, "mesh", None) is not mesh:
        raise ValueError(
            f"the loader splits its batches over 'space'; "
            f"{type(module).__name__} must be built on the same mesh "
            "(mesh=) to take the split fields")
    if mesh is None or (mesh.data == 1 and not split):
        return None, None, False
    reduction = getattr(module, "batch_reduction", "mean")
    if reduction not in ("mean", "sum", "global"):
        raise ValueError(
            f"{type(module).__name__}'s loss does not split over the batch "
            f"(batch_reduction={reduction!r}); it cannot train data-parallel")
    return mesh, reduction, split


def _loss_fn(module, mesh, reduction):
    """The loss of a batch that a step over `mesh` (None: this process's
    batch) minimises: ``module.training_loss``, or for ``"global"`` the
    loss of the module's parts summed over 'data', the global batch's on
    every rank."""
    if reduction != "global":
        return module.training_loss

    def loss_fn(batch):
        parts = all_reduce_sum(module.training_parts(batch), mesh, "data")
        return module.loss_from_parts(parts.unbind(0))
    return loss_fn


def _reduce_into(grads: list, mesh, axis: str, op: str) -> None:
    """Replace `grads` by their sum or mean over `axis`, in one
    all-reduce."""
    if not grads:
        return
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axis,
                           op)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


class _Objective(NamedTuple):
    """One optimizer, its scheduler, its step function, its chunk
    function (a list of batches to their losses; None for single steps),
    and the CUDA graphs of its L-BFGS evaluations (None without)."""
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: Callable
    chunk: Callable | None = None
    graphs: Any = None


class _GraphedChunks:
    """Chunks of optimizer steps of ``loss_fn`` on the card, one CUDA graph
    a chunk shape (the number of batches and their shapes and types).

    A shape's first chunk runs its steps eagerly on a side stream (the
    warm-up a capture needs; the optimizer's state exists after it), then
    captures them: the batches are stacked into static ``[K, ...]``
    buffers, each step takes its batch as a view of them, and the K losses
    go to a static vector. Every later chunk of that shape copies its
    batches into the buffers and replays. The learning rate of every
    parameter group is a device tensor (made so here): before a chunk it
    is scaled by nan_guard's ``0.5 ** restores`` and after it the
    scheduler steps K times, on the tensor, between replays. Milestones
    fall between epochs, and chunks never span one, so the rate is
    constant within a chunk. A kernel the graph holds adds to its op's
    launch count at each replay (``krylov.capture_graph``).

    The loss must launch kernels only, on the current stream, and read
    nothing back to the host: a host read raises at the capture, as does
    an optimizer that cannot be captured. :meth:`reset` drops the graphs
    (after the optimizer's state is loaded anew, its tensors are new)."""

    def __init__(self, loss_fn, opt, sched, trainer):
        self.loss_fn, self.opt, self.sched = loss_fn, opt, sched
        self.trainer = trainer
        self.reset()

    def reset(self) -> None:
        self.graphs = {}
        for g in self.opt.param_groups:
            if not torch.is_tensor(g["lr"]):
                g["lr"] = torch.tensor(g["lr"],
                                       device=g["params"][0].device)

    def _steps(self, xs: list, n: int) -> torch.Tensor:
        losses = []
        for k in range(n):
            self.opt.zero_grad(set_to_none=True)
            loss = self.loss_fn(tuple(x[k] for x in xs))
            loss.backward()
            self.opt.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    def __call__(self, batches: list) -> torch.Tensor:
        n = len(batches)
        key = (n,) + tuple((t.shape, t.dtype) for t in batches[0])
        scale = 0.5 ** self.trainer._nan_restores
        lrs = [g["lr"] for g in self.opt.param_groups]
        for lr in lrs:
            lr.mul_(scale)
        try:
            if key not in self.graphs:
                xs = [torch.stack(parts) for parts in zip(*batches)]
                with warnings.catch_warnings():
                    # capturable Adam warns when it steps uncaptured
                    warnings.filterwarnings("ignore",
                                            message=".*capturable=True")
                    losses, *graph = capture_graph(
                        lambda *xs: self._steps(xs, n), *xs,
                        what="Trainer(steps_per_call): the chunk of "
                             "optimizer steps")
                self.graphs[key] = (xs, *graph)
            else:
                xs, graph, out, counts = self.graphs[key]
                for x, parts in zip(xs, zip(*batches)):
                    torch.stack(parts, out=x)
                replay_graph(graph, counts)
                losses = out.clone()
        finally:
            for lr in lrs:
                lr.div_(scale)
        if self.sched is not None:
            for _ in range(n):
                self.sched.step()
        return losses


class _GraphedLoss:
    """``loss_fn(batch)`` and its gradients with respect to `params` on the
    card, one CUDA graph a batch shape (the shapes and types of its
    tensors): L-BFGS's evaluations, every line-search trial a replay. A
    shape's first call runs eagerly on a side stream and captures
    (``krylov.capture_graph``); a later call copies its batch into the
    graph's tensors and replays. The parameters are read where they are,
    so the optimizer's in-place moves of them need no copy. A loss that
    cannot be captured (a host read) runs eagerly from then on, with a
    warning. Returns the loss (a fresh tensor) and the gradients (zeros
    for a parameter the loss does not reach; under a graph its own
    tensors, which the next call overwrites). :meth:`reset` drops the
    graphs."""

    def __init__(self, loss_fn, params: list):
        self.loss_fn, self.params = loss_fn, params
        self.reset()

    def reset(self) -> None:
        self.graphs = {}   # shape key -> (batch, graph, outputs, counts)
        self.last = None   # the batch the graphs' inputs hold

    def _value_and_grads(self, *batch) -> tuple:
        loss = self.loss_fn(batch)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return (loss.detach(), *(torch.zeros_like(p) if g is None else g
                                 for p, g in zip(self.params, grads)))

    def __call__(self, batch: tuple) -> tuple:
        key = tuple((t.shape, t.dtype) for t in batch)
        if key not in self.graphs:
            xs = [t.clone() for t in batch]
            try:
                out, *graph = capture_graph(
                    self._value_and_grads, *xs,
                    what="Trainer: an L-BFGS evaluation of the loss")
                self.graphs[key], self.last = (xs, *graph), batch
                return out[0], out[1:]
            except RuntimeError as e:
                warnings.warn(f"{e}; it runs eagerly", RuntimeWarning)
                self.graphs[key] = None
        entry = self.graphs[key]
        if entry is None:
            out = self._value_and_grads(*batch)
            return out[0], out[1:]
        xs, graph, static, counts = entry
        if batch is not self.last:   # an update's trials share their batch
            for x, t in zip(xs, batch):
                x.copy_(t)
            self.last = batch
        replay_graph(graph, counts)
        return static[0].clone(), static[1:]


class Trainer:
    """Explicit training loop.

    Parameters
    ----------
    max_epochs : int (epochs to run, after a resumed state's too)
    optimizer : 'adam' | 'sgd' | 'lbfgs' | a callable ``params ->
        torch.optim.Optimizer``; in round-robin mode also a list with one
        of those per objective
    learning_rate : for adam/sgd; defaults to ``module.learning_rate``
    lbfgs_max_iter : LBFGS iterations per step
    callbacks, run_dir, log_every : observability (CSV in `run_dir`)
    checkpoint : save last/best/state checkpoints to `run_dir`
    fast_dev_run : one batch of one epoch
    seed : loader shuffle seed
    lr_milestones, lr_gamma : epochs at which adam's or sgd's learning rate
        is multiplied by `lr_gamma`
    round_robin : one optimizer per objective of the module, the objective
        rotating once a batch
    profile_dir : write a ``torch.profiler`` Chrome trace of the fit there
    nan_guard : restore ``state.ckpt`` on a non-finite epoch loss
        (needs `checkpoint`), halving adam's and sgd's learning rate
    device : where the module and the batches go (the card by default);
        'cuda' raises when no GPU is available
    steps_per_call : adam's and sgd's steps in chunks of this many batches,
        each chunk one CUDA graph on the card (see the module docstring);
        the same losses and parameters as single steps
    """

    def __init__(self, max_epochs: int = 1, optimizer: Any = "adam",
                 learning_rate: float | None = None, lbfgs_max_iter: int = 5,
                 callbacks: Sequence[Callback] = (),
                 run_dir: str | None = None, log_every: int = 1,
                 checkpoint: bool = False, fast_dev_run: bool = False,
                 seed: int = 42, device: str | torch.device = "cuda",
                 lr_milestones: Sequence[int] | None = None,
                 lr_gamma: float = 0.1, round_robin: bool = False,
                 profile_dir: str | None = None, nan_guard: bool = False,
                 steps_per_call: int = 1):
        self.max_epochs = 1 if fast_dev_run else max_epochs
        self.optimizer_spec = optimizer
        if lr_milestones and _spec_key(optimizer) == "lbfgs":
            raise ValueError("lr_milestones apply to adam and sgd; lbfgs "
                             "takes unit steps from its line search")
        if isinstance(optimizer, (list, tuple)) and not round_robin:
            raise ValueError("a list of optimizers requires round_robin=True")
        self.lr_milestones = lr_milestones
        self.lr_gamma = lr_gamma
        self.learning_rate = learning_rate
        self.lbfgs_max_iter = lbfgs_max_iter
        self.round_robin = round_robin
        self.profile_dir = profile_dir
        self.nan_guard = nan_guard
        self.steps_per_call = max(1, int(steps_per_call))
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
        self.trace_path: str | None = None   # the profiler's trace
        self._nan_restores = 0
        self._pending_switch: dict | None = None
        self._objectives: list[_Objective] = []
        self._rr_counter = 0
        self._last_obj_loss: list = []
        self._mesh = None           # fit's data mesh, None without one
        self._reduction = None      # its module's batch_reduction
        self._split = False         # whether its batches split over 'space'
        self._graphed = False       # whether chunks run as CUDA graphs

    # -- optimizers and steps --------------------------------------------
    def request_optimizer_switch(self, optimizer, learning_rate=None,
                                 lbfgs_max_iter=None):
        """Queue an optimizer swap; fit() applies it between epochs, after
        the on_epoch_end callbacks (see OptimizerSwitch). The parameters
        carry over, the optimizer state starts fresh. In round-robin mode
        `optimizer` may be a list with one spec per objective."""
        self._pending_switch = {"optimizer": optimizer,
                                "learning_rate": learning_rate,
                                "lbfgs_max_iter": lbfgs_max_iter}

    def _all_reduce(self, loss: torch.Tensor, params: list) -> torch.Tensor:
        """With a data mesh: replace this rank's gradients of `params` and
        its loss by the global batch's, in one all-reduce over 'data' (a sum
        or a mean, as the module's ``batch_reduction``; ``"global"``: the
        mean of the gradients, the loss already global); returns the global
        loss, detached. A parameter that this rank's rows left without a
        gradient gets a zero one, so that every rank reduces the same
        layout. Batches split over 'space' first average the gradients
        over 'space': each rank's backward of the loss, which every space
        rank computes in full, carries ``size('space')`` times its share
        (see ``parallel.all_reduce_sum``). Without a mesh, `loss` as it
        is."""
        if self._mesh is None:
            return loss
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self._split:
            _reduce_into(grads, self._mesh, "space", "mean")
            if self._mesh.data == 1:
                return loss.detach()
        dtype = grads[0].dtype if grads else loss.dtype
        own_loss = self._reduction == "global"
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + ([] if own_loss else
                            [loss.detach().reshape(1).to(dtype)]))
        flat = self._mesh.all_reduce(
            flat, "data", "mean" if own_loss else self._reduction)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return loss.detach() if own_loss else flat[-1].to(loss.dtype)

    def _step_fn(self, loss_fn, opt, sched, params=None, turns=False,
                 graphed=None):
        """One optimizer step of ``loss_fn(batch)``. With `params` (a
        round-robin objective's) only their gradients are taken. An LBFGS
        step is ``lbfgs_max_iter`` updates, each evaluation through
        `graphed` (a :class:`_GraphedLoss`) where given; with `turns` (a
        round-robin objective) its first update is evaluated anew and the
        optimizer's parameters outside `params` are put back after every
        update."""
        synced = params if params is not None else [
            p for g in opt.param_groups for p in g["params"]]

        def backward(loss):
            """Gradients of `loss`, global over a data mesh; returns the
            loss (the global one over a mesh)."""
            if params is None:
                loss.backward()
            else:
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                for p, g in zip(params, grads):
                    p.grad = g
            return self._all_reduce(loss, synced)

        if isinstance(opt, ZoomLBFGS):
            n_updates = self.lbfgs_max_iter
            own = {id(p) for p in synced}
            frozen = [p for g in opt.param_groups for p in g["params"]
                      if id(p) not in own]

            def step(batch):
                def closure():
                    opt.zero_grad(set_to_none=True)
                    if graphed is None:
                        return backward(loss_fn(batch))
                    loss, grads = graphed(batch)
                    for p, g in zip(synced, grads):
                        p.grad = g
                    return loss
                # JAX's turn (_build_objective_step): the cached pair was
                # taken before the other objectives' moves, and the frozen
                # subtrees are pinned to the turn's start after each update
                start = [p.detach().clone() for p in frozen]
                for k in range(n_updates):
                    # the loss logged: the value at the last update's start
                    loss = opt.step(closure, fresh=turns and k == 0)
                    for p, s in zip(frozen, start):
                        p.detach().copy_(s)
                return loss
            return step

        def step(batch):
            opt.zero_grad(set_to_none=True)
            loss = backward(loss_fn(batch))
            # nan_guard's back-off: the learning rate times 0.5 a restore
            # for this update (exact in both directions: a power of two)
            scale = 0.5 ** self._nan_restores
            for g in opt.param_groups:
                g["lr"] *= scale
            opt.step()
            for g in opt.param_groups:
                g["lr"] /= scale
            if sched is not None:
                sched.step()
            return loss
        return step

    def _objective(self, spec, loss_fn, params, lr, spe, scoped,
                   every=None):
        """`params`: the objective's parameters; `every` (a round-robin
        objective's): all of the module's, over which ``"lbfgs"`` runs, as
        the JAX Trainer's optax.lbfgs runs over the whole tree."""
        lbfgs = _spec_key(spec) == "lbfgs"
        opt = _make_optimizer(spec, every if lbfgs and scoped else params,
                              lr, graphed=self._graphed)
        sched = None
        lbfgs = isinstance(opt, ZoomLBFGS)
        if self.lr_milestones and not lbfgs:
            sched = torch.optim.lr_scheduler.MultiStepLR(
                opt, [int(m) * spe for m in self.lr_milestones],
                gamma=self.lr_gamma)
        graphed = None
        if lbfgs and self.device.type == "cuda" and self._mesh is None:
            # an L-BFGS evaluation a graph replay: its line search takes up
            # to 20 an update
            graphed = _GraphedLoss(
                loss_fn, params if scoped else opt.param_groups[0]["params"])
        step = self._step_fn(loss_fn, opt, sched, params if scoped else None,
                             turns=scoped, graphed=graphed)
        chunk = None
        if self.steps_per_call > 1 and not (lbfgs or scoped
                                            or self.fast_dev_run):
            if self._graphed:
                chunk = _GraphedChunks(loss_fn, opt, sched, self)
            else:
                def chunk(batches):
                    return torch.stack([step(b).detach() for b in batches])
        return _Objective(opt, sched, step, chunk, graphed)

    def _build_objectives(self, module, lr: float, spe: int) -> None:
        """Every optimizer, scheduler and step function from
        ``self.optimizer_spec``, their states fresh."""
        spec = self.optimizer_spec
        if not self.round_robin:
            self._objectives = [self._objective(
                spec, _loss_fn(module, self._mesh, self._reduction),
                list(module.parameters()), lr, spe, scoped=False)]
            return
        n_obj = module.num_objectives
        if isinstance(spec, (list, tuple)):
            if len(spec) != n_obj:
                raise ValueError(f"{len(spec)} optimizers given for "
                                 f"{n_obj} objectives")
            specs = list(spec)
        else:
            specs = [spec] * n_obj
        named = dict(module.network.named_parameters())
        every = list(module.parameters())
        mask_hook = getattr(module, "objective_param_mask", None)
        self._objectives = []
        for i in range(n_obj):
            names = mask_hook(i) if mask_hook is not None else None
            if names is None:
                params = every
            else:
                unknown = set(names) - set(named)
                if unknown:
                    raise ValueError(f"objective {i}: no network parameter "
                                     f"named {sorted(unknown)}")
                params = [named[n] for n in names]
            self._objectives.append(self._objective(
                specs[i], lambda batch, i=i: module.objective_loss(i, batch),
                params, lr, spe, scoped=True, every=every))
        self._last_obj_loss = [None] * n_obj

    def _train_state(self, module, n_steps: int) -> TrainState:
        opts = tuple(o.optimizer for o in self._objectives)
        scheds = tuple(o.scheduler for o in self._objectives)
        if not self.round_robin:
            opts, scheds = opts[0], scheds[0]
        return TrainState(module.network.state_dict(), opts, n_steps, scheds)

    def _save_state(self, state: TrainState, epoch: int) -> None:
        if not self._writes:
            return
        save_state(state, os.path.join(self.run_dir, "state.ckpt"),
                   epoch=epoch, rr_counter=self._rr_counter,
                   optimizer_spec=_spec_key(self.optimizer_spec),
                   lbfgs_max_iter=self.lbfgs_max_iter)

    def _restore(self, module, ck: dict, lr: float, spe: int) -> int:
        """Load a state.ckpt dict into the module and the optimizers
        (rebuilt first when the checkpoint was written after an optimizer
        switch); returns its step."""
        spec = ck.get("optimizer_spec")
        if spec is not None and spec != _spec_key(self.optimizer_spec):
            self.optimizer_spec = spec
            self.lbfgs_max_iter = int(ck["lbfgs_max_iter"])
            self._build_objectives(module, lr, spe)
        module.network.load_state_dict(ck["params"])
        opt_states, sched_states = ck["opt_state"], ck.get("sched_state")
        if not self.round_robin:
            opt_states, sched_states = [opt_states], [sched_states]
        for obj, o, s in zip(self._objectives, opt_states,
                             sched_states or [None] * len(opt_states)):
            obj.optimizer.load_state_dict(o)
            if obj.scheduler is not None and s is not None:
                obj.scheduler.load_state_dict(s)
            if isinstance(obj.chunk, _GraphedChunks):
                obj.chunk.reset()   # the loaded state's tensors are new
        self._rr_counter = int(ck.get("rr_counter", ck["step"]))
        return int(ck["step"])

    def _apply_switch(self, module, lr: float, spe: int) -> float:
        pending, self._pending_switch = self._pending_switch, None
        if pending["lbfgs_max_iter"] is not None:
            self.lbfgs_max_iter = int(pending["lbfgs_max_iter"])
        if pending["learning_rate"] is not None:
            self.learning_rate = lr = pending["learning_rate"]
        self.optimizer_spec = pending["optimizer"]
        self._build_objectives(module, lr, spe)
        return lr

    # -- fit ---------------------------------------------------------------
    def fit(self, module, dataloader=None, params=None,
            val_dataloader=None, resume_from: str | None = None
            ) -> TrainState:
        """Train `module`. Without `dataloader`, one is built from
        ``module.dataset``. `params` (a state dict of ``module.network``)
        replaces the network's parameters first. `val_dataloader` adds a
        per-epoch ``val_loss`` metric. `resume_from` (a ``state.ckpt``)
        continues a run exactly where it stopped: `max_epochs` more epochs,
        numbered on from the checkpoint's."""
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
        self._mesh, self._reduction, self._split = _data_mesh(dataloader,
                                                              module)
        if self._reduction == "global" and self.round_robin:
            raise ValueError(
                "round_robin over a data mesh needs objectives that split "
                f"over the batch; {type(module).__name__}'s do not "
                "(batch_reduction='global')")
        lr = self.learning_rate or getattr(module, "learning_rate", 3e-4)
        spe = len(dataloader)
        self._graphed = (self.device.type == "cuda" and self._mesh is None
                         and self.steps_per_call > 1
                         and not (self.round_robin or self.fast_dev_run))
        self._rr_counter = 0
        self._build_objectives(module, lr, spe)
        n_steps, first_epoch = 0, 0
        if resume_from:
            ck = load_state(resume_from, map_location=self.device)
            n_steps = self._restore(module, ck, lr, spe)
            first_epoch = int(ck.get("epoch", -1)) + 1
        if self._mesh is not None:
            # every rank starts from the first rank's parameters
            replicate([t.data for t in module.parameters()]
                      + [t for t in module.buffers()
                         if t.is_floating_point()], self._mesh)

        for cb in self.callbacks:
            cb.on_train_start(self, module,
                              self._train_state(module, n_steps))

        prof = None
        if self.profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        best = np.inf
        try:
            for epoch in range(first_epoch, first_epoch + self.max_epochs):
                t0 = time.perf_counter()
                losses = []
                module.train()
                chunk = self._objectives[0].chunk
                pending = []

                def flush():
                    losses.extend(chunk(pending).detach().unbind(0))
                    pending.clear()

                for batch in dataloader:
                    batch = tuple(t.to(self.device) for t in batch)
                    if chunk is not None:
                        # a batch of another shape (a ragged last one)
                        # cannot join the pending chunk: flush it first
                        if pending and [(t.shape, t.dtype) for t in batch] \
                                != [(t.shape, t.dtype) for t in pending[0]]:
                            flush()
                        pending.append(batch)
                        n_steps += 1
                        if len(pending) == self.steps_per_call:
                            flush()
                        continue
                    if self.round_robin:
                        i = self._rr_counter % len(self._objectives)
                        self._rr_counter += 1
                        loss = self._objectives[i].step(batch).detach()
                        self._last_obj_loss[i] = loss
                    else:
                        loss = self._objectives[0].step(batch).detach()
                    losses.append(loss)
                    n_steps += 1
                    if self.fast_dev_run:
                        break
                if pending:
                    flush()   # the epoch's remainder: a chunk of its own
                losses = torch.stack(losses)
                self.step_losses = losses.tolist()
                epoch_loss = float(losses.mean())
                if self.nan_guard and not math.isfinite(epoch_loss):
                    n_steps = self._nan_restore(module, epoch, epoch_loss,
                                                lr, spe)
                    continue
                dt = time.perf_counter() - t0
                self.epoch_times.append(dt)
                metrics = {"epoch": epoch, "loss": epoch_loss,
                           "PDE_loss": epoch_loss, "time_sec": dt}
                for i, v in enumerate(self._last_obj_loss
                                      if self.round_robin else ()):
                    if v is not None:
                        metrics[f"loss_obj{i}"] = float(v)
                if val_dataloader is not None:
                    vmesh, vred, _ = _data_mesh(val_dataloader, module)
                    vfn = _loss_fn(module, vmesh, vred)
                    with torch.no_grad():
                        vlosses = [vfn(tuple(t.to(self.device) for t in b))
                                   for b in val_dataloader]
                    vloss = torch.stack(vlosses).mean()
                    if vmesh is not None and vred != "global":
                        vloss = vmesh.all_reduce(vloss, "data", vred)
                    metrics["val_loss"] = float(vloss)
                if self.logger and self._writes \
                        and epoch % self.log_every == 0:
                    self.logger.log(metrics)
                self.state = self._train_state(module, n_steps)
                if self.checkpoint and self._writes:
                    save_params(self.state.params,
                                os.path.join(self.run_dir, "last.ckpt"))
                    self._save_state(self.state, epoch)
                    if epoch_loss < best:
                        best = epoch_loss
                        save_params(self.state.params,
                                    os.path.join(self.run_dir, "best.ckpt"))
                for cb in self.callbacks:
                    cb.on_epoch_end(self, module, self.state, epoch,
                                    metrics)
                if self._pending_switch is not None:
                    lr = self._apply_switch(module, lr, spe)
                    self.state = self._train_state(module, n_steps)
                    if self.checkpoint:
                        # a resume from here starts on the new optimizers
                        self._save_state(self.state, epoch)
                if self.should_stop:
                    break
        finally:
            if prof is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                prof.stop()
        if prof is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
            self.trace_path = os.path.join(
                self.profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(self.trace_path)

        self.state = self._train_state(module, n_steps)
        for cb in self.callbacks:
            cb.on_train_end(self, module, self.state)
        return self.state

    def invalidate_step_cache(self) -> None:
        """Drop the CUDA graphs of ``steps_per_call`` chunks and of L-BFGS
        evaluations: the next call of each shape runs eagerly and is
        captured again, so a change to a
        tensor the graphs hold (a module attribute reassigned between
        epochs) is seen. A graph lives within one ``fit``; JAX's call, which
        drops its cached jitted step, runs here too."""
        for obj in self._objectives:
            for graphs in (obj.chunk, obj.graphs):
                if isinstance(graphs, (_GraphedChunks, _GraphedLoss)):
                    graphs.reset()

    @property
    def _writes(self) -> bool:
        """Whether this process writes logs and checkpoints: the data mesh's
        first rank, or the only process."""
        return self._mesh is None or self._mesh.lead

    def _nan_restore(self, module, epoch: int, epoch_loss: float, lr: float,
                     spe: int) -> int:
        """nan_guard: restore state.ckpt (the step it holds is returned);
        raise when there is none or after NAN_GUARD_RESTORES restores."""
        ckpt = os.path.join(self.run_dir or "", "state.ckpt")
        if not (self.checkpoint and os.path.exists(ckpt)):
            raise RuntimeError(
                f"nan_guard: non-finite loss {epoch_loss} at epoch {epoch} "
                "and no state.ckpt to restore")
        n_steps = self._restore(module, load_state(
            ckpt, map_location=self.device), lr, spe)
        self._nan_restores += 1
        if self._nan_restores > NAN_GUARD_RESTORES:
            raise RuntimeError("nan_guard: loss diverged repeatedly; aborting")
        return n_steps
