"""The port's SIMP topology optimisation (``pde/topopt.py``) against the JAX
package's, on the same seeded numpy inputs: the median filter and its
gradient where values tie, the three objectives and their gradients, the
volume projection, the objective protocol and a short ``optimize`` run
(K1's plain version on the CPU).

Tolerances: float64 (JAX under ``enable_x64``) within 1e-12 of the largest
|JAX value| for the filter and 1e-10 for the objectives and their
gradients (the same contractions in another order); the median's gradient
exactly (it routes one cotangent to one element); the volume shift in
float32 within 1e-5 (a bisection whose last steps decide on means that
differ by rounding); ``optimize``'s compliances within 1e-5 relative and
its first design within 1e-4 (float32 CG solves whose matvecs sum in
another order; see that test for why later designs part).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.pde import topopt as jtop
from diffnet_tpu_torch.pde import TopOpt2D, median_filter_3x3

F64_TOL = 1e-10


def _jax_median_grad(x, w):
    with jax.enable_x64(True):
        return np.asarray(jax.grad(lambda a: jnp.sum(
            jtop.median_filter_3x3(a) * w))(jnp.asarray(x)))


def _torch_median_grad(x, w, median=median_filter_3x3):
    t = torch.tensor(x, requires_grad=True)
    torch.sum(median(t) * torch.from_numpy(w)).backward()
    return t.grad.numpy()


def test_median_filter_values():
    x = np.random.default_rng(0).standard_normal((2, 9, 11))
    with jax.enable_x64(True):
        ref = np.asarray(jtop.median_filter_3x3(jnp.asarray(x)))
    got = median_filter_3x3(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _tied(kind):
    rng = np.random.default_rng(1)
    if kind == "uniform":       # a uniform design: nine-way ties everywhere
        return np.full((6, 7), 0.001 + 0.5**3)
    if kind == "few_levels":    # unequal values with ties
        return rng.integers(0, 3, (6, 7)).astype(np.float64)
    return rng.standard_normal((6, 7))


@pytest.mark.parametrize("kind", ["uniform", "few_levels", "distinct"])
def test_median_gradient_with_ties_matches_jax(kind):
    """The trap: JAX's median sends a patch's cotangent to one element (the
    middle of a stable sort); torch.median's backward spreads it over the
    tied ones. The port must give JAX's gradient exactly."""
    x = _tied(kind)
    w = np.random.default_rng(2).standard_normal(x.shape)
    ref = _jax_median_grad(x, w)
    np.testing.assert_array_equal(_torch_median_grad(x, w), ref)
    if kind != "distinct":
        # the trap is real: torch.median of a patch spreads its cotangent
        # over the tied values, 1/9 each on a uniform design
        def patch_median(a):
            H, W = a.shape[-2:]
            ap = torch.nn.functional.pad(a[None, None], (1, 1, 1, 1),
                                         mode="replicate")[0, 0]
            patches = torch.stack([ap[i:i + H, j:j + W] for i in range(3)
                                   for j in range(3)], -1)
            return torch.stack([p.median() for p in patches.reshape(-1, 9)]
                               ).reshape(a.shape)
        assert not np.allclose(_torch_median_grad(x, w, patch_median), ref)


class _JointField(torch.nn.Module):
    """A state and a design field, parameters named u and rho."""

    def __init__(self, u, rho):
        super().__init__()
        self.u = torch.nn.Parameter(torch.as_tensor(u))
        self.rho = torch.nn.Parameter(torch.as_tensor(rho))

    def forward(self, inputs=None):
        b = 1 if inputs is None else inputs.shape[0]
        return (self.u[None].expand((b,) + self.u.shape),
                self.rho[None].expand((b,) + self.rho.shape))


class _JJointField:
    def __init__(self, n):
        self.n = n

    def init(self, rng, sample=None):
        z = jnp.zeros((self.n, self.n))
        return {"u": z, "rho": z}

    def apply(self, params, inputs=None):
        b = 1 if inputs is None else inputs.shape[0]
        s = (b, self.n, self.n)
        return (jnp.broadcast_to(params["u"][None], s),
                jnp.broadcast_to(params["rho"][None], s))


def _problem(n, seed=3):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(x, x)
    bc1 = np.zeros((n, n)); bc1[-1, : n // 2] = 1
    bc2 = np.zeros((n, n)); bc2[0, :] = 1
    inputs = np.stack([bc1, bc2, xx, yy], -1)[None]
    forcing = (1.0 + 0.1 * rng.standard_normal((n, n, 1)))[None]
    u = rng.standard_normal((n, n))
    rho = rng.standard_normal((n, n))
    return inputs, forcing, u, rho


@pytest.mark.parametrize("form", ["reference", "variational"])
def test_objectives_and_gradients_float64(form):
    n = 9
    inputs, forcing, u, rho = _problem(n)
    tm = TopOpt2D(_JointField(u, rho), None, domain_size=n,
                  compliance_form=form, target_vf=0.3).double()
    jm = jtop.TopOpt2D(_JJointField(n), None, domain_size=n,
                       compliance_form=form, target_vf=0.3)
    tb = (torch.from_numpy(inputs), torch.from_numpy(forcing))
    with jax.enable_x64(True):
        jb = (jnp.asarray(inputs), jnp.asarray(forcing))
        params = {"u": jnp.asarray(u), "rho": jnp.asarray(rho)}
        for idx in range(3):
            val, grads = jax.jit(jax.value_and_grad(
                lambda p: jm.objective_loss(idx, p, jb)))(params)
            tm.zero_grad()
            got = tm.objective_loss(idx, tb)
            got.backward()
            assert abs(float(got.detach()) - float(val)) <= F64_TOL * max(
                1.0, abs(float(val))), idx
            for k in ("u", "rho"):
                ref = np.asarray(grads[k])
                g = getattr(tm.network, k).grad
                g = np.zeros_like(ref) if g is None else g.numpy()
                np.testing.assert_allclose(
                    g, ref, rtol=0,
                    atol=F64_TOL * max(1.0, np.abs(ref).max()))
        jl = jm.loss(jm.network.apply(params, jb[0]), *jb)
        tl = tm.loss(tm.network(tb[0]), *tb)
        assert abs(float(tl) - float(jl)) <= F64_TOL * max(1.0,
                                                          abs(float(jl)))


def test_objective_param_mask():
    n = 5
    field = _JointField(np.zeros((n, n)), np.zeros((n, n)))
    m = TopOpt2D(field, None, domain_size=n, compliance_form="variational")
    assert [m.objective_param_mask(i) for i in range(3)] == [
        ("u",), ("rho",), ("rho",)]

    class Shared(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(n, n))

    m = TopOpt2D(Shared(), None, domain_size=n,
                 compliance_form="variational")
    with pytest.raises(ValueError, match="variational"):
        m.objective_param_mask(0)
    m = TopOpt2D(Shared(), None, domain_size=n)
    assert m.objective_param_mask(1) is None


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_vf_projection_shift(dtype):
    n = 11
    rho = np.random.default_rng(4).standard_normal((n, n)).astype(dtype)
    jm = jtop.TopOpt2D(None, None, domain_size=n, target_vf=0.4)
    tm = TopOpt2D(None, None, domain_size=n, target_vf=0.4)
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jm.vf_projection_shift(jnp.asarray(rho)))
    got = tm.vf_projection_shift(torch.from_numpy(rho)).numpy()
    atol = 1e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    vf = tm.project_density(torch.from_numpy(got)).mean()
    assert abs(float(vf) - 0.4) < 1e-3


def test_optimize_matches_jax_on_cpu():
    """17^2, the JAX test's problem: the CG state solves through K1's plain
    version, the sensitivity, the projection. One outer iteration lands on
    JAX's design; over three, the first two compliances agree to rounding
    and the third within 2%: from the second design step the median routes
    cotangents among values that tie in exact arithmetic (the problem's
    mirror symmetry) by their rounding, as JAX's own float32 and float64
    runs part (0.9% at the third step)."""
    n = 17
    x = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(x, x)
    bc2 = np.zeros((n, n)); bc2[0, :] = 1
    inputs = np.stack([np.zeros((n, n)), bc2, xx, yy], -1).astype(np.float32)
    forcing = np.ones((n, n, 1), np.float32)
    for n_outer in (1, 3):
        jm = jtop.TopOpt2D(_JJointField(n), None, domain_size=n,
                           target_vf=0.4, compliance_form="variational")
        jrho, ju, jhist = jm.optimize(inputs, forcing, n_outer=n_outer)
        tm = TopOpt2D(None, None, domain_size=n, target_vf=0.4,
                      compliance_form="variational")
        trho, tu, thist = tm.optimize(inputs, forcing, n_outer=n_outer,
                                      device="cpu")
        assert thist.shape == (n_outer,)
        np.testing.assert_allclose(thist[:2], jhist[:2], rtol=1e-5)
        vf = float(tm.project_density(trho).mean())
        assert abs(vf - 0.4) < 1e-4
        if n_outer == 1:
            np.testing.assert_allclose(trho.numpy(), np.asarray(jrho),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(
                tu.numpy(), np.asarray(ju), rtol=0,
                atol=1e-4 * np.abs(np.asarray(ju)).max())
        else:
            assert thist[-1] < thist[0]
            np.testing.assert_allclose(thist[2], jhist[2], rtol=2e-2)


def test_optimize_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    m = TopOpt2D(None, None, domain_size=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.optimize(np.zeros((5, 5, 2)), np.ones((5, 5)), n_outer=1)
