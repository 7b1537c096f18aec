"""The port's finite-difference stencils against the JAX package's, on the
same seeded numpy fields.

Tolerances: in float64 (JAX under ``enable_x64``) every derivative within
1e-10 of the largest |JAX value| (both packages sum the same taps in the
same order, so they agree to rounding); the FDM Poisson loss and its
gradient in the field likewise in float64, and in float32 within 1e-5
relative (the loss; the gradient of its largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.core import fdm as jfdm
from diffnet_tpu.pde.poisson import PoissonFDM2D as JPoissonFDM2D
from diffnet_tpu_torch.core import fdm as tfdm
from diffnet_tpu_torch.pde import FDMModule, PoissonFDM2D

F64_TOL = 1e-10
F32_RTOL = 1e-5

SHAPES = {2: (2, 9, 11), 3: (2, 7, 8, 9)}
OPS = {2: ("dx", "dy", "dxx", "dyy", "laplacian"),
       3: ("dx", "dy", "dz", "dxx", "dyy", "dzz", "laplacian")}
KINDS = [("fdm", 3), ("fdm", 5), ("sobel", 3), ("sobel", 5), ("fs", 5)]


def _close64(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F64_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("mode", ["interior", "full"])
@pytest.mark.parametrize("ktype,num_pt", KINDS)
@pytest.mark.parametrize("nsd", [2, 3])
def test_every_stencil_matches_jax(nsd, ktype, num_pt, mode):
    """Each derivative along each axis, batched, in float64."""
    u = np.random.default_rng(nsd * 10 + num_pt).standard_normal(
        SHAPES[nsd])
    n = SHAPES[nsd][-1]
    jf = jfdm.make_fdm(nsd, n, ktype=ktype, num_pt=num_pt)
    tf = tfdm.make_fdm(nsd, n, ktype=ktype, num_pt=num_pt)
    assert tf.num_pt == jf.num_pt
    with jax.enable_x64(True):
        want = jax.jit(lambda v: {op: getattr(jf, op)(v, mode=mode)
                                  for op in OPS[nsd]})(
            jnp.asarray(u, jnp.float64))
    want = {op: np.asarray(w) for op, w in want.items()}
    for op in OPS[nsd]:
        got = getattr(tf, op)(torch.from_numpy(u), mode=mode)
        assert got.shape == want[op].shape, op
        _close64(got, want[op])


def test_full_mode_is_exact_on_polynomials():
    """The boundary-corrected first derivative is exact on x^2 (3-point)
    and x^3 (5-point) at every node, as the solved constants promise."""
    n = 13
    x = np.linspace(0, 1, n)
    for num_pt, p in ((3, 2), (5, 3)):
        u = torch.from_numpy(np.tile(x**p, (n, 1))[None])
        d = tfdm.make_fdm(2, n, num_pt=num_pt).dx(u, mode="full")[0]
        np.testing.assert_allclose(d.numpy(), np.tile(p * x ** (p - 1),
                                                      (n, 1)), atol=1e-10)


@pytest.mark.parametrize("kwargs,err", [
    ({"ktype": "fs", "num_pt": 7}, "fixed 5-tap"),
    ({"ktype": "fs", "num_pt": 4}, "fixed 5-tap"),
    ({"ktype": "fdm", "num_pt": 7}, "num_pt must be 3 or 5"),
    ({"nsd": 1}, "nsd must be 2 or 3"),
])
def test_guards_raise_as_jax(kwargs, err):
    kw = {"nsd": 2, "n": 9, **kwargs}
    for make in (jfdm.make_fdm, tfdm.make_fdm):
        with pytest.raises(ValueError, match=err):
            f = make(**kw)
            f.dx(torch.zeros(1, 9, 9) if make is tfdm.make_fdm
                 else jnp.zeros((1, 9, 9)))
    with pytest.raises(ValueError, match="invalid for nsd=2"):
        tfdm.make_fdm(2, 9).dz(torch.zeros(1, 9, 9))


def test_fs_upgrades_num_pt_in_direct_construction():
    assert tfdm.FDMStencils(nsd=2, n=9, ktype="fs").num_pt == 5
    assert jfdm.FDMStencils(nsd=2, n=9, ktype="fs").num_pt == 5


def test_fdm_module_derivative_api_is_full_mode():
    n = 9
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((2, n, n)))
    m = FDMModule(None, None, domain_size=n, stencil_len=5, ktype="sobel")
    f = tfdm.make_fdm(2, n, ktype="sobel", num_pt=5)
    for name, op in (("derivative_x", "dx"), ("derivative_y", "dy"),
                     ("derivative_xx", "dxx"), ("derivative_yy", "dyy"),
                     ("calc_laplacian", "laplacian")):
        got = getattr(m, name)(u)
        assert got.shape == u.shape
        assert torch.equal(got, getattr(f, op)(u, mode="full"))


def _fdm_inputs(n, seed=3):
    rng = np.random.default_rng(seed)
    nu = 1.0 + 0.5 * rng.random((n, n))
    bc2 = np.zeros((n, n))
    bc2[[0, -1], :] = 1
    bc2[:, [0, -1]] = 1
    inputs = np.stack([nu, np.zeros((n, n)), bc2], -1)[None]
    forcing = rng.standard_normal((1, n, n, 1))
    u = rng.standard_normal((2, n, n))
    return u, np.repeat(inputs, 2, 0), np.repeat(forcing, 2, 0)


def _jax_loss_and_grad(jm, u, inputs, forcing):
    """JAX's per-sample loss and the gradient of its sum, jitted once."""
    def f(v, i, fo):
        return jnp.sum(jm.loss(v, i, fo)), jm.loss(v, i, fo)

    (_, loss), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(
        *map(jnp.asarray, (u, inputs, forcing)))
    return np.asarray(loss), np.asarray(grad)


@pytest.mark.parametrize("stencil_len", [3, 5])
def test_poisson_fdm_loss_and_gradient_match_jax_float64(stencil_len):
    """PoissonFDM2D's per-sample loss (the interior crop of 5-point
    stencils included) and its gradient in the field, float64."""
    n = 17
    u, inputs, forcing = _fdm_inputs(n)
    jm = JPoissonFDM2D(None, None, domain_size=n, stencil_len=stencil_len)
    tm = PoissonFDM2D(None, None, domain_size=n, stencil_len=stencil_len)
    with jax.enable_x64(True):
        jl, jg = _jax_loss_and_grad(jm, u, inputs, forcing)
    tu = torch.from_numpy(u).requires_grad_()
    tl = tm.loss(tu, torch.from_numpy(inputs), torch.from_numpy(forcing))
    tl.sum().backward()
    assert tl.shape == (2,)
    _close64(tl.detach(), jl)
    _close64(tu.grad, jg)


def test_poisson_fdm_loss_and_gradient_match_jax_float32():
    n = 17
    u, inputs, forcing = (a.astype(np.float32) for a in _fdm_inputs(n, 4))
    jm = JPoissonFDM2D(None, None, domain_size=n)
    tm = PoissonFDM2D(None, None, domain_size=n)
    jl, jg = _jax_loss_and_grad(jm, u, inputs, forcing)
    tu = torch.from_numpy(u).requires_grad_()
    tl = tm.loss(tu, torch.from_numpy(inputs), torch.from_numpy(forcing))
    tl.sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=F32_RTOL)
    np.testing.assert_allclose(tu.grad.numpy(), jg, rtol=0,
                               atol=F32_RTOL * np.abs(jg).max())
