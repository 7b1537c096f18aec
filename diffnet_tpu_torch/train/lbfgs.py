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

The line search (:func:`_strong_wolfe`) is torch's with two pieces of
optax's zoom line search, which the JAX Trainer's L-BFGS runs. (1) The
approximate decrease (Hager and Zhang): a trial step whose loss lies
within 1e-6 |f| of the start and whose slope meets the curvature
condition is taken, although the loss did not fall by the Armijo margin.
Near a minimum the loss's rounding hides the decrease that the slope
still shows. (2) In the zoom, an interpolated step within 0.2 of the
bracket's width from either end becomes the bisection: where the loss is
flat to its rounding the cubic lands next to the low end, and torch's
search shrank the bracket onto it and ended at t = 0. Without them a
float32 energy fit stalled once its loss stopped falling (the immersed
Poisson instances at 64^2 from zeros: rel L2 1e-4 to 6e-4 on a CPU, where
the JAX Trainer reaches 2e-7 to 3e-6; with them 2e-7 to 2e-6).
"""

from __future__ import annotations

import torch
from torch.optim.lbfgs import _cubic_interpolate

__all__ = ["LBFGS"]


APPROX_DEC_RTOL = 1e-6   # optax's approx_dec_rtol


def _strong_wolfe(obj_func, x, t, d, f, g, gtd, c1=1e-4, c2=0.9,
                  tolerance_change=1e-9, max_ls=25):
    """torch's strong-Wolfe line search (``torch.optim.lbfgs``), which
    takes a trial step at once where optax's approximate decrease and the
    curvature condition hold, and bisects where the zoom's cubic lands
    near a bracket's end (see the module docstring). Elsewhere it is
    torch's, step for step."""
    d_norm = d.abs().max()
    g = g.clone(memory_format=torch.contiguous_format)
    f_new, g_new = obj_func(x, t, d)
    ls_func_evals = 1
    gtd_new = g_new.dot(d)
    f_tol = f + APPROX_DEC_RTOL * abs(f)

    def approx_wolfe(f_new, gtd_new):
        return f_new <= f_tol and abs(gtd_new) <= -c2 * gtd

    # bracket an interval containing a point satisfying the Wolfe criteria
    t_prev, f_prev, g_prev, gtd_prev = 0, f, g, gtd
    done = False
    ls_iter = 0
    while ls_iter < max_ls:
        if approx_wolfe(f_new, gtd_new):
            bracket, bracket_f, bracket_g = [t], [f_new], [g_new]
            done = True
            break
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev,
                         g_new.clone(memory_format=torch.contiguous_format)]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            bracket, bracket_f, bracket_g = [t], [f_new], [g_new]
            done = True
            break
        if gtd_new >= 0:
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev,
                         g_new.clone(memory_format=torch.contiguous_format)]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        # interpolate
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                               bounds=(min_step, max_step))
        # next step
        t_prev = tmp
        f_prev = f_new
        g_prev = g_new.clone(memory_format=torch.contiguous_format)
        gtd_prev = gtd_new
        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = g_new.dot(d)
        ls_iter += 1

    if ls_iter == max_ls:
        bracket = [0, t]
        bracket_f = [f, f_new]
        bracket_g = [g, g_new]

    # zoom: refine the bracket until a point satisfies the criteria
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
    while not done and ls_iter < max_ls:
        if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0],
                               bracket[1], bracket_f[1], bracket_gtd[1])
        # optax's safeguard: an interpolated step within 0.2 of the
        # bracket's width from either end is replaced by the bisection
        # (torch's tried such a step once: where the loss is flat to its
        # rounding, the cubic lands next to the low end, the bracket
        # shrinks onto it and the search ends at t = 0)
        lo, hi = min(bracket), max(bracket)
        if not lo + 0.2 * (hi - lo) < t < hi - 0.2 * (hi - lo):
            t = 0.5 * (lo + hi)

        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = g_new.dot(d)
        ls_iter += 1

        if approx_wolfe(f_new, gtd_new):
            bracket[low_pos] = t
            bracket_f[low_pos] = f_new
            bracket_g[low_pos] = g_new.clone(
                memory_format=torch.contiguous_format)
            bracket_gtd[low_pos] = gtd_new
            done = True
        elif f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
            # Armijo condition not satisfied or not lower than lowest point
            bracket[high_pos] = t
            bracket_f[high_pos] = f_new
            bracket_g[high_pos] = g_new.clone(
                memory_format=torch.contiguous_format)
            bracket_gtd[high_pos] = gtd_new
            low_pos, high_pos = ((0, 1) if bracket_f[0] <= bracket_f[1]
                                 else (1, 0))
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                # old high becomes new low
                bracket[high_pos] = bracket[low_pos]
                bracket_f[high_pos] = bracket_f[low_pos]
                bracket_g[high_pos] = bracket_g[low_pos]
                bracket_gtd[high_pos] = bracket_gtd[low_pos]
            # new point becomes new low
            bracket[low_pos] = t
            bracket_f[low_pos] = f_new
            bracket_g[low_pos] = g_new.clone(
                memory_format=torch.contiguous_format)
            bracket_gtd[low_pos] = gtd_new

    t = bracket[low_pos]
    return bracket_f[low_pos], bracket_g[low_pos], t, ls_func_evals


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
