"""The port of ``optax.lbfgs()`` (``diffnet_tpu_torch.train.lbfgs.
ZoomLBFGS``) against optax 0.2.6's on the CPU, update by update, from the
same numpy start: the stepsize each update's zoom line search takes, its
number of evaluations, and the iterate.

Cases: a convex quadratic; a 6-variable Rosenbrock function; the 17^2
resmin loss of scripts/precision_study.py in float64 and in float32; and
two searches that fail: a linear function (no stepsize meets the
curvature condition: the safe stepsize of sufficient decrease is taken,
2^19) and a quadratic with a bump that lifts every point but the start
(no sufficient decrease: the last stepsize tried is taken, although the
loss rose).

Tolerances: the stepsizes within 1e-4 relative and the line searches'
evaluations equal; each iterate within 1e-5 x max(1, max |x|) of optax's
(the two packages sum a dot product in other orders; the float32 updates
agree to a few ulps: 3.8e-6 of max |x| on the quadratic on this CPU).
The resmin loss in float64 (JAX under ``enable_x64``) within 1e-9 of
both (1.6e-11 of max |x| at most on this CPU). In float32 its
conditioning (about 1e4) turns update 1's rounding (1e-6 of max |x|)
into a direction 1e-2 apart, and the searches part from update 2: there
update 0's stepsize and evaluations equal optax's, each iterate lies
within 2e-2 x max(1, max |x|) of optax's and the tenth within
1e-4 (1.0e-2 and 2.5e-5 on this CPU)."""

import numpy as np
import pytest
import torch

from tests.test_torch_studies import jax_script, one_torch_thread  # noqa: F401

UPDATES = 10
STEP_RTOL = 1e-4
X_ATOL = 1e-5
F64_RTOL = 1e-9
F32_RESMIN_ATOL = 2e-2
F32_RESMIN_LAST_ATOL = 1e-4


def _quadratic():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((12, 12))
    a = (m @ m.T / 12 + 0.1 * np.eye(12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    return (lambda x: 0.5 * x @ (a @ x) - b @ x,
            lambda x: 0.5 * x @ (torch.from_numpy(a) @ x)
            - torch.from_numpy(b) @ x,
            np.zeros(12, np.float32))


def _rosenbrock():
    def f(x, lib):
        return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1 - x[:-1]) ** 2)
    import jax.numpy as jnp
    return (lambda x: f(x, jnp), lambda x: f(x, torch),
            np.tile(np.array([-1.2, 1.0], np.float32), 3))


def _linear():
    c = np.linspace(0.5, 1.5, 6).astype(np.float32)
    return (lambda x: x @ c, lambda x: x @ torch.from_numpy(c),
            np.ones(6, np.float32))


def _bump():
    """0.5 |x|^2 plus 10 tanh(|x - x0|^2 / 1e-8), the bump without a
    gradient: its value rises at every point but x0."""
    import jax

    x0 = np.linspace(-1.2, 1.2, 6).astype(np.float32)

    def jf(x):
        return 0.5 * (x @ x) + jax.lax.stop_gradient(
            10.0 * jax.numpy.tanh(((x - x0) @ (x - x0)) / 1e-8))

    def tf(x):
        d = x - torch.from_numpy(x0)
        return 0.5 * (x @ x) + (10.0 * torch.tanh((d @ d) / 1e-8)).detach()
    return jf, tf, x0


def _resmin_17(dtype=np.float32):
    """scripts/precision_study.py's resmin loss at 17^2 (its
    ``solve_mms(17, "f32")``, in `dtype`), in both packages, on a flat
    field."""
    import jax.numpy as jnp

    from diffnet_tpu.core import fem as jfem
    from diffnet_tpu.core.quadrature import make_basis
    from diffnet_tpu_torch.examples import precision_study as pps

    jps = jax_script("precision_study")
    n = 17
    basis = make_basis(2, 1, h=(1 / (n - 1),) * 2)
    xg, yg = jfem.gp_coords(basis, (n, n))
    f_gp = jnp.asarray((2 * np.pi**2 * np.sin(np.pi * xg)
                        * np.sin(np.pi * yg)).astype(np.float32)[None])
    bc = np.zeros((n, n), np.float32)
    bc[[0, -1], :] = 1.0
    bc[:, [0, -1]] = 1.0

    def jf(x):
        u = jnp.where(bc > 0.5, 0.0, x.reshape(1, n, n))
        r = jps.residual(u, jnp.ones_like(u), f_gp.astype(x.dtype), basis, n,
                         jnp.asarray(bc))
        return jnp.sum(r ** 2)

    dev = torch.device("cpu")
    tbasis, _, tf_gp, tbc = pps._mms_problem(n, dev)

    def tf(x):
        u = torch.where(tbc > 0.5, torch.zeros((), dtype=x.dtype),
                        x.view(1, n, n))
        r = pps.residual(u, torch.ones_like(u), tf_gp.to(x.dtype), tbasis, n,
                         tbc)
        return torch.sum(r ** 2)
    return jf, tf, np.zeros(n * n, dtype)


CASES = {"quadratic": _quadratic, "rosenbrock": _rosenbrock,
         "resmin_17_f64": lambda: _resmin_17(np.float64),
         "resmin_17_f32": _resmin_17, "linear_safe_step": _linear,
         "bump_last_step": _bump}


def _optax_run(jf, x0):
    import jax
    import jax.numpy as jnp
    import optax

    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(jf)

    @jax.jit
    def step(u, st):
        v, g = vg(u, state=st)
        up, st = opt.update(g, st, u, value=v, grad=g, value_fn=jf)
        return optax.apply_updates(u, up), st

    out = []
    with jax.enable_x64(x0.dtype == np.float64):
        u = jnp.asarray(x0)
        st = opt.init(u)
        for _ in range(UPDATES):
            u, st = step(u, st)
            ls = optax.tree.get(st, "info")
            out.append((np.asarray(u),
                        float(optax.tree.get(st, "learning_rate")),
                        int(ls.num_linesearch_steps)))
    return out


def _port_run(tf, x0):
    from diffnet_tpu_torch.train.lbfgs import ZoomLBFGS

    x = torch.tensor(x0, requires_grad=True)
    opt = ZoomLBFGS([x])

    def closure():
        x.grad = None
        loss = tf(x)
        loss.backward()
        return loss

    out = []
    for _ in range(UPDATES):
        opt.step(closure)
        st = opt.state[x]
        out.append((x.detach().numpy().copy(), st["stepsize"],
                    st["linesearch_steps"]))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_zoom_lbfgs_follows_optax(case):
    jf, tf, x0 = CASES[case]()
    ref, got = _optax_run(jf, x0), _port_run(tf, x0)
    assert got[-1][0].dtype == x0.dtype
    if case == "resmin_17_f32":
        assert got[0][1:] == ref[0][1:], (got[0][1:], ref[0][1:])
        for k, ((xr, _, _), (xg, _, _)) in enumerate(zip(ref, got)):
            atol = F32_RESMIN_LAST_ATOL if k == UPDATES - 1 else \
                F32_RESMIN_ATOL
            assert float(np.abs(xg - xr).max()) <= atol * max(
                1.0, float(np.abs(xr).max())), (k, np.abs(xg - xr).max())
        return
    step_rtol, x_atol = ((F64_RTOL, F64_RTOL) if x0.dtype == np.float64
                         else (STEP_RTOL, X_ATOL))
    for k, ((xr, tr, nr), (xg, tg, ng)) in enumerate(zip(ref, got)):
        assert abs(tg - tr) <= step_rtol * abs(tr), (case, k, tg, tr)
        assert ng == nr, (case, k, ng, nr)
        scale = max(1.0, float(np.abs(xr).max()))
        assert float(np.abs(xg - xr).max()) <= x_atol * scale, (case, k)
    if case == "linear_safe_step":
        # every search fails; each takes its safe stepsize, the largest
        # of sufficient decrease it tried
        assert all(n == 20 and t == 2.0 ** 19 for _, t, n in got)
    if case == "bump_last_step":
        # no trial decreases the loss: the last one tried is taken
        assert all(n == 20 and 0 < t < 1e-5 for _, t, n in got)
