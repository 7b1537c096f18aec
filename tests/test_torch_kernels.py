"""The port's kernel ops (diffnet_tpu_torch.ops) against the JAX package.

On the CPU the port's wrappers run their plain torch versions; these are held
to the JAX Pallas ops, run in interpret mode with the same monkeypatch as
tests/test_pallas_kernel.py, and to the JAX XLA paths. Inputs come from
``np.random.default_rng`` and go to both packages as the same numpy arrays.

Tolerances: fields at atol=2e-6 (the JAX kernel tests' own tolerance for
K(nu)u with O(1) inputs in float32); scalars at rtol=1e-5 (float32 sums over
~1e3 terms in different orders); K2 gradients, whose entries reach O(10), at
1e-4 of their largest entry, as the JAX K2 test holds them.

The CUDA kernels themselves are checked against their plain versions on the
card by tests/test_torch_cuda.py.
"""

import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import diffnet_tpu.ops.poisson_energy as jen
import diffnet_tpu.ops.poisson_loss_grad as jlg
import diffnet_tpu.ops.poisson_residual as jpr
from diffnet_tpu.core import fem as jfem
from diffnet_tpu.core.quadrature import make_basis as jmake_basis
from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.ops import poisson_energy as ten
from diffnet_tpu_torch.ops import poisson_loss_grad as tlg
from diffnet_tpu_torch.ops import poisson_residual as tpr


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _h(shape, aniso=False):
    ny, nx = shape
    if aniso:
        return (0.7 / (nx - 1), 1.9 / (ny - 1))
    return (1.0 / (nx - 1), 1.0 / (ny - 1))


def _bases(shape, aniso=False):
    h = _h(shape, aniso)
    return jmake_basis(2, 1, h=h), fem.BasisTables(make_basis(2, 1, h=h))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def _K_xla(u, nu, jb, shape):
    gp = jfem.gp_eval(u, jb, ("dx", "dy"))
    nug = jfem.gp_eval(nu, jb, ("N",))["N"]
    return (jfem.galerkin_project(nug * gp["dx"], jb, "dx", shape)
            + jfem.galerkin_project(nug * gp["dy"], jb, "dy", shape))


def _wall_mask(shape):
    bc = np.zeros(shape, np.float32)
    bc[[0, -1], :] = 1
    bc[:, [0, -1]] = 1
    return bc


K1_CASES = [((2, 33, 33), True), ((2, 40, 40), False), ((2, 24, 49), False)]


# ---- K1: stiffness action ---------------------------------------------------

@pytest.mark.parametrize("shape,aniso", K1_CASES)
def test_stiffness_action_matches_jax(shape, aniso):
    jb, tb = _bases(shape[1:], aniso)
    rng = np.random.default_rng(0)
    u, nu = (rng.random(shape, np.float32) for _ in range(2))
    Kt = tpr.poisson_stiffness_action(_t(u), _t(nu), tb)
    Kp = jpr.poisson_stiffness_action(jnp.asarray(u), jnp.asarray(nu), jb, 16)
    Kx = _K_xla(jnp.asarray(u), jnp.asarray(nu), jb, shape[1:])
    np.testing.assert_allclose(_np(Kt), np.asarray(Kp), atol=2e-6)
    np.testing.assert_allclose(_np(Kt), np.asarray(Kx), atol=2e-6)


@pytest.mark.parametrize("shape,aniso", K1_CASES)
def test_stiffness_action_vjp_matches_jax(shape, aniso):
    jb, tb = _bases(shape[1:], aniso)
    rng = np.random.default_rng(1)
    u, nu, g = (rng.random(shape, np.float32) for _ in range(3))
    ju, jnu = jnp.asarray(u), jnp.asarray(nu)
    gj = jax.grad(lambda u, nu: jnp.sum(
        jpr.poisson_stiffness_action(u, nu, jb, 16) * g),
        argnums=(0, 1))(ju, jnu)
    tu, tnu = _t(u, True), _t(nu, True)
    (tpr.poisson_stiffness_action(tu, tnu, tb) * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(tu.grad), np.asarray(gj[0]), atol=2e-6)
    np.testing.assert_allclose(_np(tnu.grad), np.asarray(gj[1]), atol=2e-6)


@pytest.mark.parametrize("batched_mask", [False, True])
def test_residual_fused_matches_jax(batched_mask):
    n = 33
    jb, tb = _bases((n, n), aniso=True)
    rng = np.random.default_rng(2)
    u, nu, Nf = (rng.random((2, n, n), np.float32) for _ in range(3))
    bc = _wall_mask((n, n))
    if batched_mask:
        bc = np.stack([bc, (rng.random((n, n)) > 0.7).astype(np.float32)])
    Rj = jpr.poisson_residual_fused(jnp.asarray(u), jnp.asarray(nu),
                                    jnp.asarray(Nf), jnp.asarray(bc), jb, 16)
    Rt = tpr.poisson_residual_fused(_t(u), _t(nu), _t(Nf), _t(bc), tb)
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=2e-6)


# ---- K2: resmin loss and gradient -------------------------------------------

def _loss_xla(u, nu, Nf, bc, jb, shape):
    R = jnp.where(bc > 0.5, 0.0, _K_xla(u, nu, jb, shape) - Nf)
    return jnp.sum(R**2)


@pytest.mark.parametrize("n,nf_plane", [(17, False), (33, False),
                                        (33, True)])
def test_loss_grad_matches_jax(n, nf_plane):
    """Value and the u, nu and Nf cotangents against the JAX K2 op and the
    XLA loss; anisotropic h; Nf per sample or one plane for the batch."""
    jb, tb = _bases((n, n), aniso=True)
    rng = np.random.default_rng(3)
    u = rng.random((2, n, n), np.float32)
    nu = rng.random((2, n, n), np.float32) + 0.5
    Nf = rng.random((n, n) if nf_plane else (2, n, n), np.float32)
    bc = _wall_mask((n, n))
    args = [jnp.asarray(a) for a in (u, nu, Nf)]
    lx, gx = jax.value_and_grad(
        lambda u, nu, Nf: _loss_xla(u, nu, Nf, jnp.asarray(bc), jb, (n, n)),
        argnums=(0, 1, 2))(*args)
    tu, tnu, tNf = _t(u, True), _t(nu, True), _t(Nf, True)
    lt = tlg.poisson_resmin_loss_fused(tu, tnu, tNf, _t(bc), tb)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lx), rtol=1e-5)
    for a, b in zip((tu.grad, tnu.grad, tNf.grad), gx):
        np.testing.assert_allclose(_np(a), np.asarray(b),
                                   atol=1e-4 * float(jnp.max(jnp.abs(b))))
    if n == 17:   # the JAX K2 op (batched Nf only), slow in interpret mode
        lp, gp = jax.value_and_grad(
            lambda u, nu, Nf: jlg.poisson_resmin_loss_fused(
                u, nu, Nf, jnp.asarray(bc), jb, 8),
            argnums=(0, 1, 2))(*args)
        np.testing.assert_allclose(lt.item(), float(lp), rtol=1e-5)
        for a, b in zip((tu.grad, tnu.grad, tNf.grad), gp):
            np.testing.assert_allclose(
                _np(a), np.asarray(b), atol=1e-4 * float(jnp.max(jnp.abs(b))))


def test_loss_grad_fractional_mask_follows_xla_et_path():
    """A fractional bc: the port masks with where(bc > 0.5), as the XLA
    resmin path does (poisson_resmin_residual_et), not with the JAX K2
    kernel's multiplicative R*(1-bc)."""
    from diffnet_tpu.data.single_instances import RectangleManufactured
    from diffnet_tpu.models.field import DirectField as JDirectField
    from diffnet_tpu.pde.poisson import (Poisson2D as JPoisson2D,
                                         poisson_resmin_residual_et)

    n = 17
    m = JPoisson2D(JDirectField((n, n)), RectangleManufactured(n),
                   domain_size=n, loss_type="resmin")
    jb, tb = _bases((n, n))
    rng = np.random.default_rng(4)
    u = rng.random((2, n, n), np.float32)
    nu = rng.random((2, n, n), np.float32) + 0.5
    f_gp = rng.random((2, n - 1, n - 1, 4), np.float32)
    bc = rng.random((2, n, n)).astype(np.float32)
    R = poisson_resmin_residual_et(m, jnp.asarray(u), jnp.asarray(nu),
                                   jnp.asarray(f_gp), jnp.asarray(bc))
    lx, gx = jax.value_and_grad(
        lambda u: jnp.sum(poisson_resmin_residual_et(
            m, u, jnp.asarray(nu), jnp.asarray(f_gp), jnp.asarray(bc))**2))(
        jnp.asarray(u))
    Nf = fem.galerkin_project(_t(f_gp), tb, "N", (n, n))
    tu = _t(u, True)
    lt = tlg.poisson_resmin_loss_fused(tu, _t(nu), Nf, _t(bc), tb)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(jnp.sum(R**2)), rtol=1e-5)
    np.testing.assert_allclose(lt.item(), float(lx), rtol=1e-5)
    np.testing.assert_allclose(_np(tu.grad), np.asarray(gx),
                               atol=1e-4 * float(jnp.max(jnp.abs(gx))))
    # the JAX K2 kernel's multiplicative mask gives another loss here
    lk = jlg.poisson_resmin_loss_fused(
        jnp.asarray(u), jnp.asarray(nu), jnp.asarray(_np(Nf)),
        jnp.asarray(bc), jb, 8)
    assert abs(float(lk) - lt.item()) > 1e-3 * lt.item()


# ---- K3: Ritz energy --------------------------------------------------------

def _energy_xla(u, nu, f, jb):
    gp = jfem.gp_eval(u, jb, ("N", "dx", "dy"))
    nug = jfem.gp_eval(nu, jb, ("N",))["N"]
    fg = jfem.gp_eval(f, jb, ("N",))["N"]
    jxw = jnp.asarray(jb.jxw, u.dtype)
    res = jxw * (0.5 * nug * (gp["dx"] ** 2 + gp["dy"] ** 2) - gp["N"] * fg)
    return jnp.mean(jnp.sum(res, axis=-1))


@pytest.mark.parametrize("shape,aniso", [((2, 33, 33), True),
                                         ((2, 40, 40), False),
                                         ((1, 65, 65), False)])
def test_energy_and_vjp_match_jax(shape, aniso):
    jb, tb = _bases(shape[1:], aniso)
    rng = np.random.default_rng(5)
    u, f = (rng.random(shape, np.float32) for _ in range(2))
    nu = rng.random(shape, np.float32) + 0.5
    args = [jnp.asarray(a) for a in (u, nu, f)]
    Ep, gp = jax.value_and_grad(
        lambda u, nu, f: jen.poisson_energy_fused(u, nu, f, jb, 16),
        argnums=(0, 1, 2))(*args)
    Ex = _energy_xla(*args, jb)
    tu, tnu, tf = _t(u, True), _t(nu, True), _t(f, True)
    Et = ten.poisson_energy_fused(tu, tnu, tf, tb)
    Et.backward()
    np.testing.assert_allclose(Et.item(), float(Ep), rtol=1e-5)
    np.testing.assert_allclose(Et.item(), float(Ex), rtol=1e-5)
    for a, b in zip((tu.grad, tnu.grad, tf.grad), gp):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-6)


def test_energy_rectangular_matches_xla():
    """The JAX kernel is square-only; the port's takes rectangles, held to
    the XLA energy (mean over all elements)."""
    shape = (2, 24, 49)
    jb, tb = _bases(shape[1:])
    rng = np.random.default_rng(6)
    u, nu, f = (rng.random(shape, np.float32) for _ in range(3))
    Ex = _energy_xla(*(jnp.asarray(a) for a in (u, nu, f)), jb)
    Et = ten.poisson_energy_fused(_t(u), _t(nu), _t(f), tb)
    np.testing.assert_allclose(Et.item(), float(Ex), rtol=1e-5)


# ---- bfloat16 fields (K1, K3) -----------------------------------------------

def _bf16_inputs(shape, seed):
    """bfloat16 torch fields and the same values for JAX, from numpy."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.random(shape, np.float32)).bfloat16()
          for _ in range(3)]
    return ts, [jnp.asarray(_np(t.float())).astype(jnp.bfloat16) for t in ts]


@pytest.mark.parametrize("shape", [(1, 33, 33), (2, 40, 40)])
def test_stiffness_action_bf16_matches_jax(shape):
    """bfloat16 u and nu: the port keeps the type, and its result and the
    JAX kernel's (interpret mode) are each within 3% in norm of the float32
    XLA path, the JAX package's own bar (test_pallas_kernel.py:332)."""
    n = shape[1]
    jb, tb = _bases((n, n))
    (u, nu, _), (ju, jnu, _) = _bf16_inputs(shape, 10)
    Kt = tpr.stiffness_action(u, nu, tb)
    assert Kt.dtype == torch.bfloat16
    Kp = jpr._stiffness_fwd_impl(ju, jnu, jb, 16)
    assert Kp.dtype == jnp.bfloat16
    Kx = np.asarray(_K_xla(ju.astype(jnp.float32), jnu.astype(jnp.float32),
                           jb, (n, n)))
    for K in (_np(Kt.float()), np.asarray(Kp, np.float32)):
        assert np.linalg.norm(K - Kx) / np.linalg.norm(Kx) < 0.03
    # one rounding from the float32 plain version
    K32 = tpr.stiffness_action(u.float(), nu.float(), tb)
    torch.testing.assert_close(Kt, K32.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 33, 33), (2, 40, 40)])
def test_energy_bf16_matches_jax(shape):
    n = shape[1]
    jb, tb = _bases((n, n))
    (u, nu, f), (ju, jnu, jf) = _bf16_inputs(shape, 11)
    Et = ten.energy(u, nu, f, tb)
    assert Et.dtype == torch.bfloat16
    Ep = float(jen._energy_fwd_impl(ju, jnu, jf, jb, 16))
    Ex = float(_energy_xla(*(a.astype(jnp.float32) for a in (ju, jnu, jf)),
                           jb))
    for E in (float(Et), Ep):
        assert abs(E - Ex) < 0.03 * abs(Ex)


def test_bf16_vjps_run_in_the_input_type():
    """K1's and K3's backward give bfloat16 cotangents for bfloat16 fields,
    within bfloat16 resolution of the float32 ones."""
    _, tb = _bases((17, 17))
    (u, nu, f), _ = _bf16_inputs((2, 17, 17), 12)
    g = torch.rand(2, 17, 17, generator=torch.Generator().manual_seed(0))
    for fn in (lambda u, nu, f: (tpr.poisson_stiffness_action(u, nu, tb)
                                 * g.to(u.dtype)).sum(),
               lambda u, nu, f: ten.poisson_energy_fused(u, nu, f, tb)):
        grads = {}
        for dt in (torch.bfloat16, torch.float32):
            xs = [x.detach().to(dt).requires_grad_(True) for x in (u, nu, f)]
            fn(*xs).backward()
            grads[dt] = [x.grad for x in xs]
        for a, b in zip(*grads.values()):
            if b is None:
                continue
            assert a.dtype == torch.bfloat16
            assert float((a.float() - b).norm() / b.norm()) < 0.03


# ---- wrapper contracts ------------------------------------------------------

# types each wrapper refuses: K1 and K3 take float32 or bfloat16 (one type
# for all fields), K2 float32 only
REFUSED = [(op, dt) for op in ("k1", "k3") for dt in ("float64", "float16",
                                                      "mixed")] + \
    [("k2", dt) for dt in ("float64", "float16", "bfloat16")]


@pytest.mark.parametrize("op,dtype", REFUSED)
def test_wrappers_reject_what_the_kernels_do_not_take(op, dtype):
    _, tb = _bases((9, 9))
    x = torch.zeros(2, 9, 9)

    def call(u, nu=None):
        nu = x if nu is None else nu
        if op == "k1":
            return tpr.stiffness_action(u, nu, tb)
        if op == "k2":
            return tlg.resmin_loss_grad(u, nu, u, u[0], tb)
        return ten.energy(u, nu, u, tb)

    if dtype == "mixed":
        with pytest.raises(TypeError, match="one type"):
            call(x, x.bfloat16())
    else:
        bad = getattr(torch, dtype)
        with pytest.raises(TypeError, match="float32"):
            call(x.to(bad), x.to(bad))
    with pytest.raises(ValueError, match="contiguous"):
        call(x, torch.zeros(2, 9, 9).transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        call(x, torch.zeros(1, 9, 9))
    with pytest.raises(ValueError, match=r"\[B, ny, nx\]"):
        call(torch.zeros(9, 9), torch.zeros(9, 9))
    with pytest.raises(ValueError, match="not supported"):
        call(x.to("meta"), x.to("meta"))


# ---- K2 and K3: the CUDA kernels' tilings, transcribed in float64 ----------
#
# csrc/poisson2d.cu's loss_grad_kernel and energy_kernel run no element
# twice: lanes own node columns, walk down rows, and take their right
# neighbour's values by shuffle. These transcriptions follow the kernels
# lane by lane (a lane is an entry of a 32-vector, a shuffle a shift), tile
# by tile, step by step, and hold the result to the plain versions.

def _shfl_down(v):
    """__shfl_down_sync(v, 1): lane i gets lane i + 1's value, lane 31 its
    own."""
    return torch.cat([v[1:], v[-1:]])


def _body(k, c00, c01, c10, c11, n00, n01, n10, n11):
    """K1's element body on 32-vectors of corners: (a0, a1, a2, a3)."""
    U = torch.stack([torch.stack([c00, c01], -1),
                     torch.stack([c10, c11], -1)], -2)
    N = torch.stack([torch.stack([n00, n01], -1),
                     torch.stack([n10, n11], -1)], -2)
    return [t[:, 0, 0] for t in tpr.element_contributions(U, N, k)]


def _node(F, r, col):
    """F[r, col] for a scalar row and a vector of columns, 0 outside."""
    ny, nx = F.shape
    ok = (col >= 0) & (col < nx) & (0 <= r < ny)
    return torch.where(ok, F[min(max(r, 0), ny - 1), col.clamp(0, nx - 1)],
                       torch.zeros((), dtype=F.dtype))


def _k2_transcribed(u, nu, Nf, bc, k, ty):
    """loss_grad_kernel: per-warp partials of sum R^2 and the gradient;
    each gradient node must be written exactly once."""
    B, ny, nx = u.shape
    Nf, bc = Nf.expand(u.shape), bc.expand(u.shape)
    grad = torch.full_like(u, float("nan"))
    partials = []
    lane = torch.arange(32)
    zero = torch.zeros(32, dtype=u.dtype)
    for b, y0, x0 in ((b, y0, x0) for b in range(B)
                      for y0 in range(0, ny, ty)
                      for x0 in range(0, nx, tlg.COLS)):
        a = x0 - 2 + 2 * lane
        e1a = (a >= 0) & (a < nx - 1)
        e1b = (a + 1 >= 0) & (a + 1 < nx - 1)
        e2b = (a + 2 >= 0) & (a + 2 < nx - 1)
        own_p, own_q = (lane >= 1) & (lane <= 30), lane <= 30
        out0, out1 = (lane <= 30) & (a + 2 < nx), (lane <= 29) & (a + 3 < nx)
        steps = min(ty, ny - y0) + 3

        def un(r):
            return ([_node(u[b], r, a + i) for i in range(3)],
                    [_node(nu[b], r, a + i) for i in range(3)])

        ut, nt = un(y0 - 2)
        nt3 = _shfl_down(nt[1])
        np_, np3 = [zero] * 3, zero
        carry0 = carry1 = gc0 = gc1 = rp = rq = rn = zero
        sq = zero
        for s in range(steps):
            e = y0 - 2 + s
            ub, nb = un(e + 1)
            fq = [_node(Nf[b], e, a + 1), _node(Nf[b], e, a + 2)]
            bq = [_node(bc[b], e, a + 1), _node(bc[b], e, a + 2)]
            nb3 = _shfl_down(nb[1])
            row_ok = 0 <= e < ny - 1
            A = [t * (row_ok & e1a) for t in _body(
                k, ut[0], ut[1], ub[0], ub[1], nt[0], nt[1], nb[0], nb[1])]
            Bb = [t * (row_ok & e1b) for t in _body(
                k, ut[1], ut[2], ub[1], ub[2], nt[1], nt[2], nb[1], nb[2])]
            r0, r2 = _shfl_down(A[0]), _shfl_down(A[2])
            kp, kq = (carry0 + A[1]) + Bb[0], (carry1 + Bb[1]) + r0
            carry0, carry1 = A[3] + Bb[2], Bb[3] + r2
            Rp = torch.where(bq[0] > 0.5, zero, kp - fq[0])
            Rq = torch.where(bq[1] > 0.5, zero, kq - fq[1])
            Rn = _shfl_down(Rp)
            if 2 <= s <= ty + 1:
                sq = sq + own_p * Rp * Rp + own_q * Rq * Rq
            if s >= 2:
                e2 = e - 1
                row2 = 0 <= e2 < ny - 1
                C = [t * (row2 & e1b) for t in _body(
                    k, rp, rq, Rp, Rq, np_[1], np_[2], nt[1], nt[2])]
                D = [t * (row2 & e2b) for t in _body(
                    k, rq, rn, Rq, Rn, np_[2], np3, nt[2], nt3)]
                q0, q2 = _shfl_down(C[0]), _shfl_down(C[2])
                if s >= 3:
                    for col, ok, v in ((a + 2, out0, (gc0 + C[1]) + D[0]),
                                       (a + 3, out1, (gc1 + D[1]) + q0)):
                        assert torch.isnan(grad[b, e2, col[ok]]).all()
                        grad[b, e2, col[ok]] = 2.0 * v[ok]
                gc0, gc1 = C[3] + D[2], D[3] + q2
            np_, np3, nt, nt3, ut = nt, nt3, nb, nb3, ub
            rp, rq, rn = Rp, Rq, Rn
        partials.append(sq.sum())
    return torch.stack(partials), grad


def _k3_transcribed(u, nu, f, c, ty):
    """energy_kernel: per-warp partials of the summed element energies."""
    B, ny, nx = u.shape
    lane = torch.arange(32)
    partials = []
    for b, y0, x0 in ((b, y0, x0) for b in range(B)
                      for y0 in range(0, ny - 1, ty)
                      for x0 in range(0, nx - 1, ten.COLS)):
        x = x0 + 2 * lane
        ok = [x < nx - 1, x + 1 < nx - 1]
        cols = [x.clamp(max=nx - 1), (x + 1).clamp(max=nx - 1),
                (x + 2).clamp(max=nx - 1)]
        acc = torch.zeros(32, dtype=u.dtype)
        for ey in range(y0, min(y0 + ty, ny - 1)):
            for i in range(2):
                tile = [F[b, ey:ey + 2][:, torch.stack(cols[i:i + 2], -1)]
                        .permute(1, 0, 2) for F in (u, nu, f)]
                e = ten.element_energy(*tile, c)[:, 0, 0]
                acc = acc + torch.where(ok[i], e, torch.zeros_like(e))
        partials.append(acc.sum())
    return torch.stack(partials)


TILING_SHAPES = [(1, 17, 130), (2, 33, 40), (1, 10, 77)]


@pytest.mark.parametrize("shape", TILING_SHAPES)
@pytest.mark.parametrize("per_sample", [False, True])
def test_k2_tiling_transcription_matches_the_plain_version(shape,
                                                           per_sample):
    """The CUDA K2's tiling (R from element-once sums on the tile plus its
    halo, then K(R) one row behind, per-warp partials) in float64, at
    several tile heights: within 1e-12 of the plain version."""
    rng = np.random.default_rng(11)
    B, ny, nx = shape
    _, tb = _bases((ny, nx), aniso=True)
    u, nu, Nf = (torch.tensor(rng.random(shape)) for _ in range(3))
    nu = nu + 0.5
    plane = shape if per_sample else (ny, nx)
    bc = torch.tensor((rng.random(plane) > 0.8).astype(np.float64))
    if not per_sample:
        Nf = Nf[0]
    loss_p, grad_p = tlg.resmin_loss_grad_plain(u, nu, Nf, bc, tb)
    k = tpr.stiffness_consts(tb.basis)
    for ty in (1, 3, 8, 32):
        partials, grad = _k2_transcribed(u, nu, Nf, bc, k, ty)
        assert not torch.isnan(grad).any()
        scale = float(grad_p.abs().max())
        assert float((grad - grad_p).abs().max()) <= 1e-12 * scale
        assert abs(float(partials.sum() - loss_p)) <= 1e-12 * float(loss_p)


@pytest.mark.parametrize("shape", TILING_SHAPES)
def test_k3_tiling_transcription_matches_the_plain_version(shape):
    """The CUDA K3's tiling (lanes own element pairs, walk down rows,
    per-warp partials) in float64, at several tile heights: within 1e-12 of
    the plain version's algebra (energy_plain computes in float32, so the
    float64 reference is its body, ``element_energy``, averaged)."""
    rng = np.random.default_rng(12)
    _, tb = _bases(shape[1:], aniso=True)
    u, nu, f = (torch.tensor(rng.random(shape)) for _ in range(3))
    c = ten.energy_consts(tb.basis)
    ref = float(ten.element_energy(u, nu, f, c).mean())
    n_el = shape[0] * (shape[1] - 1) * (shape[2] - 1)
    for ty in (1, 3, 8, 32):
        E = float(_k3_transcribed(u, nu, f, c, ty).sum()) / n_el
        assert abs(E - ref) <= 1e-12 * abs(ref)


def test_k2_k3_strip_rows_at_the_timed_shapes():
    """K2's and K3's tile heights at every shape chip_smoke.py and
    scripts/kernel_turns.py time: the longest strip that still gives each
    of an H100's SMs its warps, shorter on small grids, always one the
    kernel takes."""
    sms = 132
    for mod, nodes in ((tlg, lambda n: n), (ten, lambda n: n - 1)):
        for shape in ((32, 512, 512), (1, 513, 513), (8, 256, 256),
                      (1, 64, 64), (1, 2, 2)):
            B, ny, nx = shape
            ty = mod.strip_rows(*shape, sms)
            assert ty in mod.STRIPS and 1 <= ty <= 64
            warps = B * -(-nodes(nx) // mod.COLS)
            longer = [t for t in mod.STRIPS if t > ty]
            assert all(warps * -(-nodes(ny) // t)
                       < mod.MIN_WARPS_PER_SM * sms for t in longer)
            if ty != mod.STRIPS[-1]:
                assert warps * -(-nodes(ny) // ty) >= \
                    mod.MIN_WARPS_PER_SM * sms


def test_strip_rows_fill_the_card():
    """K1's tile height: the longest strip while the launch gives each SM
    its warps, shorter on small grids, never past the kernel's set."""
    sms = 132
    assert tpr.strip_rows(32, 512, 512, sms) == 5
    assert tpr.strip_rows(1, 513, 513, sms) == 5
    assert tpr.strip_rows(1, 257, 257, sms) == 2
    assert tpr.strip_rows(1, 64, 64, sms) == 1
    assert tpr.strip_rows(1, 2, 2, sms) == tpr.STRIPS[-1]
    for shape in ((1, 513, 513), (1, 64, 64), (4, 257, 129)):
        ty = tpr.strip_rows(*shape, sms)
        assert ty in tpr.STRIPS
        longer = [t for t in tpr.STRIPS if t > ty]
        warps = shape[0] * -(-shape[2] // tpr.COLS)
        assert all(warps * -(-shape[1] // t) < tpr.MIN_WARPS_PER_SM * sms
                   for t in longer)


def test_misaligned_views_are_copied_for_the_kernels():
    x = torch.arange(40, dtype=torch.float32)
    assert tpr.aligned16(x) is x
    view = x[1:]
    y = tpr.aligned16(view)
    assert y.data_ptr() % 16 == 0 and torch.equal(y, view)


def test_cpu_tensors_launch_no_kernel():
    _, tb = _bases((9, 9))
    x = torch.rand(1, 9, 9)
    before = (tpr.launches, tlg.launches, ten.launches)
    tpr.stiffness_action(x, x, tb)
    tlg.resmin_loss_grad(x, x, x, x[0], tb)
    ten.energy(x, x, x, tb)
    assert (tpr.launches, tlg.launches, ten.launches) == before


# ---- the build (nvcc itself runs only on a machine with the toolkit) --------

def _fake_nvcc(monkeypatch, rc):
    """Stand in for nvcc with the Python interpreter: the "flags" are a
    program that writes the -o file, prints a ptxas line and exits with
    `rc` (nothing is executed from a temporary directory)."""
    from diffnet_tpu_torch.ops import _build

    code = ("import sys; a = sys.argv; "
            "open(a[a.index('-o') + 1], 'w').write('lib'); "
            "print('ptxas info : Used 32 registers'); "
            f"sys.exit({rc})")
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "NVCC_FLAGS", ("-c", code))
    monkeypatch.setattr(_build, "LINK_FLAGS", ("-c", code))


def test_build_compiles_once_per_source_and_renames_atomically(
        tmp_path, monkeypatch):
    from diffnet_tpu_torch.ops import _build

    assert [s.name for s in _build.SOURCES] == [
        "poisson2d.cu", "stencil2d.cu", "poisson3d.cu", "stencil3d.cu",
        "ns2d.cu"]
    assert all(s.exists() for s in _build.SOURCES)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _fake_nvcc(monkeypatch, 0)
    so, log = _build.build()
    assert so.parent == tmp_path / "_build" and "registers" in log
    # one compile per source, then the link: a ptxas line each
    assert log.count("registers") == len(_build.SOURCES) + 1
    assert [p.name for p in so.parent.iterdir()] == [so.name]  # no temp left
    assert _build.build() == (so, "")   # built already: nothing compiled
    for k, orig in enumerate(_build.SOURCES):   # any source changed
        src = tmp_path / orig.name
        src.write_text(orig.read_text() + "// changed\n")
        sources = list(_build.SOURCES)
        sources[k] = src
        with monkeypatch.context() as mp:
            mp.setattr(_build, "SOURCES", tuple(sources))
            assert _build.library_path() != so   # ... builds anew

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build_fail")
    _fake_nvcc(monkeypatch, 3)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert list((tmp_path / "_build_fail").iterdir()) == []
