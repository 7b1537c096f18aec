"""A port of ``optax.lbfgs()``: :class:`ZoomLBFGS`, the Trainer's
``"lbfgs"`` (one JAX Trainer step is ``lbfgs_max_iter`` of its updates)
and the precision study's solve.

optax's L-BFGS keeps every curvature pair whatever the sign of s . y
(torch's drops those below an absolute 1e-10 and stalls once a residual
loss nears 1e-9) and takes each direction along by Nocedal and Wright's
zoom line search with Hager and Zhang's approximate decrease (a trial
within 1e-6 |f| of the start whose slope meets the curvature condition
is taken, where the loss's rounding hides a decrease the slope still
shows). :class:`ZoomLBFGS` runs that algorithm update for update, its
scalars rounded as optax's are, so that the port's LBFGS runs can be
held to the JAX package's step by step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["ZoomLBFGS"]

# optax 0.2.6's defaults (alias.py ``lbfgs``, linesearch.py
# ``scale_by_zoom_linesearch``)
APPROX_DEC_RTOL = 1e-6    # approx_dec_rtol
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
    and sets their ``.grad`` (the closure of torch's L-BFGS; a parameter
    left without a gradient counts as a zero one, as a
    ``stop_gradient``'ed subtree in JAX).

    optax's algorithm, not torch's:

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
      again, and ``step(closure, fresh=True)`` evaluates anew, as the JAX
      Trainer's round robin does at each turn's first update).

    The parameters are one flat vector; the vector operations run where
    the parameters are, in their type, and the line search reads the
    value and the slope of each trial back to the host, one read a trial
    (its scalars round as optax's do in that type). ``state`` holds
    ``count`` (updates), ``evaluations`` (the closure's calls, summed
    over the updates), and ``stepsize`` and ``linesearch_steps`` of the
    last update."""

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
    def step(self, closure, fresh: bool = False):
        """One optax update; returns the loss at the parameters it starts
        from (a 0-dim tensor where they are). `fresh`: evaluate the
        closure there rather than take the value and gradient the last
        update accepted."""
        closure = torch.enable_grad()(closure)
        m = ZOOM_MEMORY
        st = self.state[self._params[0]]
        x = self._flat([p.detach() for p in self._params])
        value, grad = st.get("value"), st.get("grad")
        evaluated = fresh or value is None or not math.isfinite(value)
        if evaluated:
            loss, grad = self._value_and_grad(closure, x)
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

        if evaluated:
            value, slope = torch.stack([loss.to(grad.dtype),
                                        d.dot(grad)]).tolist()
        else:
            loss = torch.tensor(value, dtype=x.dtype, device=x.device)
            slope = float(d.dot(grad))

        def evaluate(t):
            v, g = self._value_and_grad(closure, x + float(t) * d)
            v_s = torch.stack([v.to(g.dtype), g.dot(d)]).tolist()
            return v_s[0], g, v_s[1]

        t, v_new, g_new, n_ls = _zoom_linesearch(
            evaluate, value, grad, slope, self._np_dtype)
        self._set(x + float(t) * d)
        st.update(count=count + 1, params=x, updates=grad,
                  value=float(v_new), grad=g_new, stepsize=float(t),
                  linesearch_steps=n_ls,
                  evaluations=st.get("evaluations", 0) + n_ls + evaluated)
        return loss
