"""Krylov solvers on torch tensors: ``cg``, ``bicgstab`` and ``gmres``.

The semantics of ``jax.scipy.sparse.linalg`` (which the JAX package's
linear solves call), kept exactly:

- the stopping rule ``|r|^2 > max(tol^2 |b|^2, atol^2)`` (cg, bicgstab;
  cg tests the unpreconditioned residual unless M is the identity), and
  ``|M r| > max(tol |b|, atol)`` between gmres restarts;
- ``x0`` (zeros by default), ``maxiter`` (default ``10 * b.numel()``; for
  gmres it counts restart cycles of ``restart`` (20) Arnoldi steps, each
  solved as one batched least-squares problem);
- the ``(x, info)`` return: ``info`` is None for cg and bicgstab, and for
  gmres a 0-dim tensor, -1 when x holds a NaN, else 0.

With ``mesh=`` the vectors are this rank's blocks of fields split along
a process mesh's 'space' axis (:mod:`diffnet_tpu_torch.parallel`): every
inner product and norm is all-reduced over 'space', so each rank takes the
unsplit solve's steps on its own rows, and ``A`` and ``M`` map blocks to
blocks (their halo exchanges are theirs). GMRES all-reduces each Arnoldi
step's projections (one vector) and norms, and every rank solves the
small Hessenberg least-squares problem from those same scalars.

The iteration reads back no scalar when ``tol == atol == 0``: each step
then computes its update for every iteration up to ``maxiter`` and keeps
the old state (``torch.where`` on a device flag) once the stopping rule has
held, which is what JAX's ``while_loop`` returns. Otherwise the loop reads
one scalar per iteration (per restart cycle for gmres) to stop. Operators
``A`` and ``M`` map a tensor of ``b``'s shape to one of the same shape.
The solves do not differentiate (they run under ``torch.no_grad``).

On CUDA tensors without a mesh, ``gmres`` runs each Arnoldi step's
``M(A(v))`` as one CUDA graph replay (:class:`CudaGraphed`: the first step
runs it eagerly and captures it, the later ones replay), since the host
work of the flow path's Jacobian action and multigrid preconditioner
dwarfs their device work. ``A`` and ``M`` must then read nothing back to
the host (a read raises at the capture) and keep no Python state that a
replay should update: a replay runs the captured kernels, not the Python
code.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

__all__ = ["cg", "bicgstab", "gmres", "CudaGraphed", "capture_graph",
           "replay_graph"]


def _launch_counters() -> list:
    """``(module, name)`` of every kernel launch count of the op modules
    (``launches``; ``launches_3d`` beside it in ``stencil_apply``)."""
    from ..ops import (ns_residual, poisson_energy, poisson_loss_grad,
                       poisson_residual, poisson_residual_3d, stencil_apply)
    return [(m, name) for m in (poisson_residual, poisson_loss_grad,
                                poisson_energy, stencil_apply,
                                poisson_residual_3d, ns_residual)
            for name in vars(m) if name.startswith("launches")]


def capture_graph(fn: Callable, *args: torch.Tensor, what: str) -> tuple:
    """``fn(*args)`` run eagerly on a side stream (the warm-up a capture
    needs), then captured as a CUDA graph on the same tensors: returns
    ``(the eager result, the graph, the graph's result, its counts)``. A
    kernel the graph holds adds to its op's launch count at each
    :func:`replay_graph` (`counts`), as its wrapper does at an eager call:
    the capture launches nothing, so what it counted is taken back. A
    capture that fails (a host read: ``.item()``, ``float()``, a branch on
    a tensor's value) raises RuntimeError naming `what`, after freeing
    the graph and taking back what its wrappers counted.

    The garbage collector does not run during the capture: a graph that it
    frees there (one in a reference cycle, as a Trainer's are) destroys
    its executable, a call CUDA refuses while a stream captures, and the
    capture in progress is lost."""
    dev = args[0].device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager = fn(*args)
    torch.cuda.current_stream(dev).wait_stream(side)
    counters = _launch_counters()
    before = [getattr(m, name) for m, name in counters]
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out = fn(*args)
        error = None
    except RuntimeError as e:
        error = e
    finally:
        if collecting:
            gc.enable()
    counts = []
    for (m, name), b in zip(counters, before):
        if getattr(m, name) != b:
            counts.append(((m, name), getattr(m, name) - b))
            setattr(m, name, b)
    if error is not None:
        graph.reset()   # now, and not by the collector inside a capture
        raise RuntimeError(
            f"{what} could not be captured as a CUDA graph; it must launch "
            "kernels only, on the current stream, and read nothing back to "
            "the host (no .item(), float() or branch on a tensor's value): "
            f"{error}") from error
    return eager, graph, out, counts


def replay_graph(graph, counts: list) -> None:
    """Replay a graph of :func:`capture_graph`, adding its kernels to their
    launch counts."""
    graph.replay()
    for (mod, name), n in counts:
        setattr(mod, name, getattr(mod, name) + n)


class CudaGraphed:
    """``fn`` (a tensor to a tensor of fixed shapes, no host reads, every
    kernel on the current stream) as a CUDA graph for inputs of the first
    call's shape and type (another raises): the first call runs it
    eagerly on a side stream (the warm-up capture needs), which also
    captures it; every later call copies its input into the graph's and
    replays. A kernel the graph holds adds to its op's launch count at
    each replay, as its wrapper does at an eager call (the capture
    itself launches nothing, so it counts nothing). Returns a fresh
    tensor. CPU tensors, and a call while another graph is being captured,
    run ``fn`` as it is.

    Python code in ``fn`` runs at the first call only: a replay repeats its
    kernels, not its side effects (a counter in ``fn`` counts the capture
    alone). A host read in ``fn`` (``.item()``, ``float()``, a branch on a
    tensor's value) raises RuntimeError at the capture."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graph = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda or torch.cuda.is_current_stream_capturing():
            # inside another capture fn's kernels join that graph
            return self.fn(x)
        if self.graph is not None:
            if (x.shape, x.dtype, x.device) != (self.x.shape, self.x.dtype,
                                                self.x.device):
                raise ValueError(f"CudaGraphed: captured for "
                                 f"{tuple(self.x.shape)} {self.x.dtype}, "
                                 f"called with {tuple(x.shape)} {x.dtype}")
            self.x.copy_(x)
            replay_graph(self.graph, self.counts)
            return self.y.clone()
        self.x = x.clone()
        out, self.graph, self.y, self.counts = capture_graph(
            self.fn, self.x, what="CudaGraphed: the operator")
        return out


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def _dot(mesh) -> Callable:
    """The inner product of fields: of whole ones, or of blocks along the
    mesh's 'space' axis, all-reduced over it."""
    if mesh is None or mesh.space == 1:
        return _vdot
    return lambda x, y: mesh.all_reduce(_vdot(x, y), "space")


def _norm(mesh) -> Callable:
    """The 2-norm of a field: of a whole one, or of blocks along the mesh's
    'space' axis (the sum of squares all-reduced over it)."""
    if mesh is None or mesh.space == 1:
        return torch.linalg.vector_norm
    return lambda x: mesh.all_reduce(torch.sum(x * x), "space").sqrt()


def _identity(x):
    return x


def _while(cond: Callable, body: Callable, state: tuple, maxsteps: int,
           readback: bool) -> tuple:
    """``lax.while_loop(cond, body, state)`` for a loop that ends within
    `maxsteps` steps. With `readback`, one scalar a step decides whether to
    go on; without, every step runs and a step whose condition failed
    leaves the state as it was."""
    done = None
    for _ in range(maxsteps):
        go = cond(state)
        if readback:
            if not bool(go):
                break
            state = body(state)
            continue
        done = ~go if done is None else done | ~go
        new = body(state)
        state = tuple(torch.where(done, s, n) for s, n in zip(state, new))
    return state


def _setup(b, x0, maxiter, M):
    if x0 is None:
        x0 = torch.zeros_like(b)
    if x0.shape != b.shape:
        raise ValueError(f"x0 and b must have matching shapes: "
                         f"{tuple(x0.shape)} vs {tuple(b.shape)}")
    if maxiter is None:
        maxiter = 10 * b.numel()
    return x0, int(maxiter), (_identity if M is None else M)


def _atol2(b, tol, atol, dot=_vdot):
    bs = dot(b, b)
    return torch.clamp(tol * tol * bs, min=atol * atol)


@torch.no_grad()
def cg(A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       tol: float = 1e-5, atol: float = 0.0, maxiter: int | None = None,
       M: Callable | None = None, mesh=None):
    """Preconditioned conjugate gradients for SPD ``A`` (``M`` SPD too);
    `mesh`: the vectors are blocks along its 'space' axis."""
    x0, maxiter, Mf = _setup(b, x0, maxiter, M)
    dot = _dot(mesh)
    atol2 = _atol2(b, tol, atol, dot)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(s):
        _, r, gamma, _, k = s
        rs = gamma if Mf is _identity else dot(r, r)
        return (rs > atol2) & (k < maxiter)

    def body(s):
        x, r, gamma, p, k = s
        Ap = A(p)
        alpha = gamma / dot(p, Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = Mf(r_)
        gamma_ = dot(r_, z_)
        p_ = z_ + (gamma_ / gamma) * p
        return x_, r_, gamma_, p_, k + 1

    r0 = b - A(x0)
    z0 = Mf(r0)
    state = (x0, r0, dot(r0, z0), z0, k0)
    x, *_ = _while(cond, body, state, maxiter, tol != 0 or atol != 0)
    return x, None


@torch.no_grad()
def bicgstab(A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
             *, tol: float = 1e-5, atol: float = 0.0,
             maxiter: int | None = None, M: Callable | None = None,
             mesh=None):
    """Preconditioned BiCGSTAB for general ``A``. A breakdown (rho, alpha or
    omega of 0) stops the iteration, as in JAX. `mesh`: the vectors are
    blocks along its 'space' axis."""
    x0, maxiter, Mf = _setup(b, x0, maxiter, M)
    dot = _dot(mesh)
    atol2 = _atol2(b, tol, atol, dot)

    def cond(s):
        r, k = s[1], s[-1]
        return (dot(r, r) > atol2) & (k < maxiter) & (k >= 0)

    def body(s):
        x, r, rhat, alpha, omega, rho, p, q, k = s
        rho_ = dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = Mf(p_)
        q_ = A(phat)
        alpha_ = rho_ / dot(rhat, q_)
        s_ = r - alpha_ * q_
        exit_early = dot(s_, s_) < atol2
        shat = Mf(s_)
        t = A(shat)
        omega_ = dot(t, s_) / dot(t, t)
        x_ = torch.where(exit_early, x + alpha_ * phat,
                         x + (alpha_ * phat + omega_ * shat))
        r_ = torch.where(exit_early, s_, s_ - omega_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        return x_, r_, rhat, alpha_, omega_, rho_, p_, q_, k_

    r0 = b - A(x0)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)
    state = (x0, r0, r0, one, one, one, r0, r0, k0)
    x, *_ = _while(cond, body, state, maxiter, tol != 0 or atol != 0)
    return x, None


def _safe_normalize(x: torch.Tensor, thresh=None,
                    norm: Callable = torch.linalg.vector_norm):
    norm = norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / norm, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _lstsq_pos(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Least squares through the normal equations, solved by Cholesky
    (JAX's ``_lstsq`` with ``assume_a='pos'``); NaN where Cholesky fails."""
    L, info = torch.linalg.cholesky_ex(a.T @ a)
    L = torch.where(info > 0, torch.full_like(L, float("nan")), L)
    return torch.cholesky_solve((a.T @ y)[:, None], L)[:, 0]


def _gmres_batched(A, M, b, x, unit_residual, residual_norm, restart,
                   mesh=None, MA=None):
    """One restart: ``restart`` Arnoldi steps (classical Gram-Schmidt, one
    pass, as JAX's two-pass routine exits after one), then the projected
    least-squares problem. Returns the new x and its normalised
    preconditioned residual. `mesh`: the vectors are blocks along its
    'space' axis; the projections and norms are all-reduced over it. `MA`:
    ``M(A(.))`` for the Arnoldi steps (a :class:`CudaGraphed`)."""
    n = b.numel()
    dtype, dev = b.dtype, b.device
    norm = _norm(mesh)
    split = mesh is not None and mesh.space > 1
    V = torch.zeros((restart + 1, n), dtype=dtype, device=dev)
    V[0] = unit_residual.reshape(-1)
    H = torch.eye(restart, restart + 1, dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps
    broke = torch.zeros((), dtype=torch.bool, device=dev)
    if MA is None:
        def MA(u):
            return M(A(u))
    for k in range(restart):
        v = MA(V[k].reshape(b.shape)).reshape(-1)
        _, v_norm_0 = _safe_normalize(v, norm=norm)
        h = V @ v
        if split:
            h = mesh.all_reduce(h, "space")
        v = v - V.T @ h
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0,
                                           norm=norm)
        h[k + 1] = v_norm_1
        # a breakdown before step k stops the loop: later rows stay as
        # they were (H an identity row, V zero)
        V[k + 1] = torch.where(broke, V[k + 1], unit_v)
        H[k] = torch.where(broke, H[k], h)
        broke = broke | (v_norm_1 == 0)
    beta = torch.zeros(restart + 1, dtype=dtype, device=dev)
    beta[0] = residual_norm
    y = _lstsq_pos(H.T, beta)
    x = x + (V[:-1].T @ y).reshape(b.shape)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)), norm=norm)
    return x, unit_residual, residual_norm


@torch.no_grad()
def gmres(A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
          tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
          maxiter: int | None = None, M: Callable | None = None,
          mesh=None):
    """Restarted GMRES, JAX's ``solve_method='batched'`` (the one the JAX
    package uses); ``maxiter`` counts restart cycles. `mesh`: the vectors
    are blocks along its 'space' axis. On CUDA tensors without a mesh each
    Arnoldi step's ``M(A(v))`` is one CUDA graph replay (see the module
    docstring for what A and M must then keep to)."""
    x0, maxiter, Mf = _setup(b, x0, maxiter, M)
    norm = _norm(mesh)
    numel = b.numel()
    if mesh is not None and mesh.space > 1:
        numel = int(mesh.all_reduce(torch.tensor(
            float(numel), device=b.device), "space"))
    restart = min(int(restart), numel)
    atol_ = torch.clamp(tol * norm(b), min=atol)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)
    MA = (CudaGraphed(lambda u: Mf(A(u)))
          if b.is_cuda and mesh is None else None)

    def cond(s):
        _, k, _, rnorm = s
        return (k < maxiter) & (rnorm > atol_)

    def body(s):
        x, k, unit, rnorm = s
        x, unit, rnorm = _gmres_batched(A, Mf, b, x, unit, rnorm, restart,
                                        mesh, MA)
        return x, k + 1, unit, rnorm

    unit0, rnorm0 = _safe_normalize(Mf(b - A(x0)), norm=norm)
    x, *_ = _while(cond, body, (x0, k0, unit0, rnorm0), maxiter,
                   tol != 0 or atol != 0)
    info = torch.where(torch.isnan(norm(x)), -1, 0)
    return x, info
