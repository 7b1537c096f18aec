"""Two L-BFGS optimizers: :class:`LBFGS`, torch's with a scale-free
curvature test (the Trainer's ``"lbfgs"``), and :class:`ZoomLBFGS`, a port
of ``optax.lbfgs()`` (the precision study's solve).

:class:`LBFGS`:

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

import math

import numpy as np
import torch
from torch.optim.lbfgs import _cubic_interpolate

__all__ = ["LBFGS", "ZoomLBFGS"]


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


# -- ZoomLBFGS: optax.lbfgs() ---------------------------------------------
# optax 0.2.6's defaults (alias.py ``lbfgs``, linesearch.py
# ``scale_by_zoom_linesearch``); the approximate decrease is APPROX_DEC_RTOL
ZOOM_MEMORY = 10          # memory_size
ZOOM_STEPS = 20           # max_linesearch_steps
ZOOM_SLOPE_RTOL = 1e-4    # slope_rtol (the Armijo margin)
ZOOM_CURV_RTOL = 0.9      # curv_rtol (the curvature condition)
ZOOM_INCREASE = 2.0       # increase_factor
ZOOM_PRECISION = 1e-5     # stepsize_precision


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through (a,
    fa), (b, fb), (c, fc) with slope fpa at a (NaN where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 + -(db ** 2) * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _nan_to_inf(x):
    return x.dtype.type(np.inf) if np.isnan(x) else x


def _zoom_linesearch(evaluate, value, grad, slope, dtype):
    """optax's zoom line search (``scale_by_zoom_linesearch`` with
    ``initial_guess_strategy='one'``, ``tol`` 0 and no largest stepsize),
    step for step: the interval search (Nocedal and Wright's algorithm
    3.5, the stepsize doubled from 1), then the zoom (3.6: the cubic
    through the bracket and its reference point, else the quadratic, else
    the bisection), with Hager and Zhang's approximate decrease.
    `evaluate(t)` returns the value, the gradient and the slope along the
    direction at stepsize t; `value`, `grad`, `slope` are those at 0. The
    scalars are numpy scalars of `dtype`, so that each operation rounds
    as optax's JAX scalars of the parameters' type do.

    On failure (ZOOM_STEPS steps, or a bracket below ZOOM_PRECISION once a
    sufficient decrease was seen) it takes optax's ``_try_safe_step``: the
    best stepsize of sufficient decrease when there is one (or when the
    last trial was not finite), else the last stepsize tried, with its
    value and gradient, although the value rose. Returns ``(stepsize,
    value, grad, steps)`` (numpy scalars, the gradient a tensor)."""
    f = dtype
    slope_rtol, curv_rtol = ZOOM_SLOPE_RTOL, ZOOM_CURV_RTOL
    value, slope = f(value), f(slope)
    value_init, slope_init = value, slope

    def errors(t, v, s):
        dec = v - value_init - slope_rtol * t * slope_init
        approx = np.maximum(s - (2 * slope_rtol - 1.0) * slope_init,
                            v - value_init - APPROX_DEC_RTOL * abs(value_init))
        dec = _nan_to_inf(np.maximum(np.minimum(approx, dec), f(0.0)))
        curv = _nan_to_inf(np.maximum(abs(s) - curv_rtol * abs(slope_init),
                                      f(0.0)))
        return dec, curv

    zero = f(0.0)
    count = 0
    t, v, g, s = zero, value, grad, slope
    dec_err = f(np.inf)
    interval_found = done = failed = False
    low, v_low, s_low = zero, value, slope
    high, v_high, s_high = zero, value, slope
    cref, v_cref = zero, value
    safe_t, safe_v, safe_g = zero, value, grad
    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                t_new = f(1.0) if count == 0 else f(ZOOM_INCREASE * t)
                v_new, g_new, s_new = evaluate(t_new)
                v_new, s_new = f(v_new), f(s_new)
                dec_err, curv_err = errors(t_new, v_new, s_new)
                err = np.maximum(dec_err, curv_err)
                if dec_err <= 0:
                    safe_t, safe_v, safe_g = t_new, v_new, g_new
                set_high = dec_err > 0 or (v_new >= v and count > 0)
                set_low = s_new >= 0 and not set_high
                if set_low:
                    low, v_low, s_low, high, v_high, s_high = (
                        t_new, v_new, s_new, t, v, s)
                else:
                    low, v_low, s_low, high, v_high, s_high = (
                        t, v, s, t_new, v_new, s_new)
                interval_found = set_high or set_low or err <= 0
                done = bool(err <= 0)
                failed = count + 1 >= ZOOM_STEPS and not done
                cref, v_cref = low, v_low
            else:
                delta = abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = delta <= ZOOM_PRECISION
                mid_c = _cubicmin(low, v_low, s_low, high, v_high, cref,
                                  v_cref)
                use_cubic = (mid_c > left + 0.2 * delta
                             and mid_c < right - 0.2 * delta)
                mid_q = _quadmin(low, v_low, s_low, high, v_high)
                use_quad = (not use_cubic and mid_q > left + 0.1 * delta
                            and mid_q < right - 0.1 * delta)
                t_new = (mid_c if use_cubic else mid_q if use_quad
                         else (low + high) / 2.0)
                v_new, g_new, s_new = evaluate(t_new)
                v_new, s_new = f(v_new), f(s_new)
                dec_err, curv_err = errors(t_new, v_new, s_new)
                err = np.maximum(dec_err, curv_err)
                if dec_err <= 0 and v_new < safe_v:
                    safe_t, safe_v, safe_g = t_new, v_new, g_new
                done = bool(err <= 0)
                to_high = dec_err > 0 or v_new >= v_low
                high_to_low = s_new * (high - low) >= 0 and not to_high
                new_cref = (high, v_high) if to_high or high_to_low else \
                    (low, v_low)
                if to_high:
                    high, v_high, s_high = t_new, v_new, s_new
                if high_to_low:
                    high, v_high, s_high = low, v_low, s_low
                if not to_high:
                    low, v_low, s_low = t_new, v_new, s_new
                cref, v_cref = new_cref
                failed = ((count + 1 >= ZOOM_STEPS
                           or (too_small and safe_t > 0)) and not done)
            count += 1
            t, v, g, s = t_new, v_new, g_new, s_new
            if failed and (safe_t > 0 or np.isinf(dec_err)):
                # optax's _try_safe_step; otherwise the last trial stands
                t, v, g = safe_t, safe_v, safe_g
    return t, v, g, count


class ZoomLBFGS(torch.optim.Optimizer):
    """``optax.lbfgs()`` at optax 0.2.6's defaults, one :meth:`step` an
    optax update, on a closure that evaluates the loss at the parameters
    and sets their ``.grad`` (``torch.optim.LBFGS``'s protocol).

    optax's algorithm, not torch's (:class:`LBFGS`):

    - the memory of ZOOM_MEMORY pairs (s, y) is a ring of that many slots,
      zeros at first, every slot taken by the two-loop recursion; a pair
      is kept with weight ``1 / (s . y)`` whatever its sign, with weight 0
      where ``s . y == 0``;
    - the identity scale is ``s . y / y . y`` of the newest pair (1 where
      ``y . y`` is 0), and the first update's ``min(1, 1 / |g|_2)``;
    - the direction is taken along by :func:`_zoom_linesearch` from a
      first trial stepsize of 1 (optax's ``initial_guess_strategy='one'``),
      at most ZOOM_STEPS evaluations, and on failure its safe step, else
      its last trial;
    - the value and gradient at the accepted step are kept and start the
      next update without a new evaluation (optax's
      ``value_and_grad_from_state``; a non-finite value is evaluated
      again).

    The parameters are one flat vector; the vector operations run where
    the parameters are, in their type, and the line search reads the
    value and the slope of each trial back to the host (its scalars round
    as optax's do in that type). ``state`` holds ``stepsize`` and
    ``linesearch_steps`` of the last update."""

    def __init__(self, params):
        super().__init__(params, {})
        if len(self.param_groups) != 1:
            raise ValueError("ZoomLBFGS takes one parameter group")
        self._params = self.param_groups[0]["params"]
        dt = self._params[0].dtype
        if any(p.dtype != dt for p in self._params) or \
                dt not in (torch.float32, torch.float64):
            raise ValueError("ZoomLBFGS takes float32 or float64 parameters "
                             "of one type")
        self._np_dtype = np.float32 if dt == torch.float32 else np.float64

    def _flat(self, tensors) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in tensors])

    def _flat_grad(self) -> torch.Tensor:
        return self._flat([torch.zeros_like(p) if p.grad is None
                           else p.grad for p in self._params])

    def _set(self, x: torch.Tensor) -> None:
        i = 0
        for p in self._params:
            p.copy_(x[i:i + p.numel()].view_as(p))
            i += p.numel()

    def _value_and_grad(self, closure, x):
        self._set(x)
        loss = closure()
        return loss.detach().reshape(()), self._flat_grad()

    @torch.no_grad()
    def step(self, closure):
        """One optax update; returns the loss at the parameters it starts
        from."""
        closure = torch.enable_grad()(closure)
        m = ZOOM_MEMORY
        st = self.state[self._params[0]]
        x = self._flat([p.detach() for p in self._params])
        value, grad = st.get("value"), st.get("grad")
        if value is None or not math.isfinite(float(value)):
            value, grad = self._value_and_grad(closure, x)
        count = st.get("count", 0)
        if count == 0:
            st["dw"] = x.new_zeros((m, x.numel()))
            st["du"] = x.new_zeros((m, x.numel()))
            st["rho"] = x.new_zeros((m,))
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad),
                                max=1.0)
        else:
            # the newest pair, kept with weight 1 / (s.y), 0 where s.y == 0
            dw, du = x - st["params"], grad - st["updates"]
            sy = du.dot(dw)
            prev = (count - 1) % m
            st["dw"][prev], st["du"][prev] = dw, du
            st["rho"][prev] = torch.where(sy == 0, torch.zeros_like(sy),
                                          1.0 / sy)
            yy = du.dot(du)
            scale = torch.where(yy > 0, sy / yy, torch.ones_like(yy))
        # the two-loop recursion over every slot, newest first
        order = [(count % m + i) % m for i in range(m)]
        dws, dus, rho = st["dw"], st["du"], st["rho"]
        q, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = rho[i] * dws[i].dot(q)
            q = q + (-alphas[i]) * dus[i]
        q = scale * q
        for i in order:
            beta = rho[i] * dus[i].dot(q)
            q = q + (alphas[i] - beta) * dws[i]
        d = -q

        def evaluate(t):
            v, g = self._value_and_grad(closure, x + float(t) * d)
            v_s = torch.stack([v.to(g.dtype), g.dot(d)]).tolist()
            return v_s[0], g, v_s[1]

        t, v_new, g_new, n_ls = _zoom_linesearch(
            evaluate, float(value), grad, float(d.dot(grad)), self._np_dtype)
        self._set(x + float(t) * d)
        st.update(count=count + 1, params=x, updates=grad,
                  value=torch.tensor(float(v_new), dtype=x.dtype),
                  grad=g_new, stepsize=float(t), linesearch_steps=n_ls)
        return value
