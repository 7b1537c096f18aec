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
