"""L-BFGS with a scale-free curvature test.

``torch.optim.LBFGS`` keeps a step's curvature pair (s, y) in its memory only
when ``s . y > 1e-10``, an absolute threshold. On the residual losses of this
package it stops the memory once the loss falls near 1e-9: the SUPG
advection-diffusion MMS at 65^2 then stalls there (rel L2 1.1e-3 on a CPU,
while the JAX package's optax L-BFGS, which keeps every pair with
``s . y != 0``, reaches 6.4e-4). :class:`LBFGS` is torch's algorithm (two-loop recursion,
``history_size`` pairs, the strong-Wolfe line search, the first step
``min(1, 1 / |g|_1) lr``) with a scale-free test: the pair is kept when
``s . y > eps |s| |y|`` (eps of the dtype), the curvature above the
rounding of its own vectors, whatever the loss's scale. Should the
memory still turn the direction uphill, it is dropped and the step is
``-H_diag g`` (torch would end the step there). A step runs its
``max_iter`` iterations, as the JAX Trainer's optax L-BFGS does, unless a
tolerance ends it: a move below a positive ``tolerance_change`` does
(torch's ``<=`` also ends a step at ``tolerance_change`` 0 where a line
search found no lower loss). Such a search leaves x, the gradient and
the memory as they were, so each further iteration of the step would
repeat it exactly: the step counts them as run and returns.
"""

from __future__ import annotations

import torch
from torch.optim.lbfgs import _strong_wolfe

__all__ = ["LBFGS"]


class LBFGS(torch.optim.LBFGS):
    """``torch.optim.LBFGS`` (same arguments and state) with the scale-free
    curvature test. Only ``line_search_fn="strong_wolfe"`` is
    supported."""

    def __init__(self, params, **kwargs):
        if kwargs.get("line_search_fn") != "strong_wolfe":
            raise ValueError("LBFGS supports line_search_fn='strong_wolfe' "
                             "only")
        super().__init__(params, **kwargs)

    @torch.no_grad()
    def step(self, closure):
        closure = torch.enable_grad()(closure)
        group = self.param_groups[0]
        lr = float(group["lr"])
        max_iter, max_eval = group["max_iter"], group["max_eval"]
        tolerance_grad = group["tolerance_grad"]
        tolerance_change = group["tolerance_change"]
        history_size = group["history_size"]

        state = self.state[self._params[0]]
        state.setdefault("func_evals", 0)
        state.setdefault("n_iter", 0)
        orig_loss = closure()
        loss = float(orig_loss)
        current_evals = 1
        state["func_evals"] += 1
        flat_grad = self._gather_flat_grad()
        if flat_grad.abs().max() <= tolerance_grad:
            return orig_loss

        d, t = state.get("d"), state.get("t")
        old_dirs, old_stps, ro = (state.get("old_dirs"), state.get("old_stps"),
                                  state.get("ro"))
        H_diag = state.get("H_diag")
        prev_flat_grad = state.get("prev_flat_grad")
        prev_loss = state.get("prev_loss")

        n_iter = 0
        while n_iter < max_iter:
            n_iter += 1
            state["n_iter"] += 1
            if state["n_iter"] == 1:
                d = flat_grad.neg()
                old_dirs, old_stps, ro = [], [], []
                H_diag = 1
            else:
                y = flat_grad.sub(prev_flat_grad)
                s = d.mul(t)
                ys = y.dot(s)
                fi = torch.finfo(ys.dtype)
                if ys > torch.clamp(fi.eps * torch.linalg.vector_norm(y)
                                    * torch.linalg.vector_norm(s),
                                    min=fi.tiny):
                    if len(old_dirs) == history_size:
                        old_dirs.pop(0)
                        old_stps.pop(0)
                        ro.pop(0)
                    old_dirs.append(y)
                    old_stps.append(s)
                    ro.append(1.0 / ys)
                    H_diag = ys / y.dot(y)
                # the two-loop recursion on 0-dim tensors: no host read
                # of a coefficient (torch's alpha= reads each one)
                al = [None] * len(old_dirs)
                q = flat_grad.neg()
                for i in range(len(old_dirs) - 1, -1, -1):
                    al[i] = old_stps[i].dot(q) * ro[i]
                    q.sub_(old_dirs[i] * al[i])
                d = r = torch.mul(q, H_diag)
                for i in range(len(old_dirs)):
                    be_i = old_dirs[i].dot(r) * ro[i]
                    r.add_(old_stps[i] * (al[i] - be_i))

            if prev_flat_grad is None:
                prev_flat_grad = flat_grad.clone(
                    memory_format=torch.contiguous_format)
            else:
                prev_flat_grad.copy_(flat_grad)
            prev_loss = loss
            t = (min(1.0, 1.0 / flat_grad.abs().sum()) * lr
                 if state["n_iter"] == 1 else lr)
            gtd = flat_grad.dot(d)
            if gtd >= 0 and old_dirs:
                # pairs of rounding-level curvature can turn the direction
                # uphill: drop the memory, keep the scale H_diag
                old_dirs, old_stps, ro = [], [], []
                d = flat_grad.mul(-H_diag)
                gtd = flat_grad.dot(d)
            if gtd > -tolerance_change:
                break

            x_init = self._clone_param()

            def obj_func(x, t, d):
                return self._directional_evaluate(closure, x, t, d)

            loss, flat_grad, t, ls_func_evals = _strong_wolfe(
                obj_func, x_init, t, d, loss, flat_grad, gtd,
                max_ls=max_eval - current_evals)
            self._add_grad(t, d)
            current_evals += ls_func_evals
            state["func_evals"] += ls_func_evals
            if (n_iter == max_iter or current_evals >= max_eval
                    or flat_grad.abs().max() <= tolerance_grad
                    or d.mul(t).abs().max() < tolerance_change
                    or abs(loss - prev_loss) < tolerance_change):
                break
            if t == 0 and state["n_iter"] > 1:
                # no lower loss on the line: the next iteration would
                # take this one's direction and search again (the first
                # iteration's shorter trial step aside)
                state["n_iter"] += max_iter - n_iter
                break

        state.update(d=d, t=t, old_dirs=old_dirs, old_stps=old_stps, ro=ro,
                     H_diag=H_diag, prev_flat_grad=prev_flat_grad,
                     prev_loss=prev_loss)
        return orig_loss
