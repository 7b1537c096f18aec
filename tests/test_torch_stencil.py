"""The port's assembled-stencil path (K4's plain version and autograd, and
``train.stencil``) against the JAX package's, on the same numpy inputs.

The JAX Pallas stencil apply runs in interpret mode (same monkeypatch as
tests/test_stencil_apply_kernel.py); the port's K4 wrapper runs its plain
version on the CPU. Tolerances follow the JAX tests: fields at atol 2e-6
times max(1, max |ref|) (O(1) float32 stencils, sums in other orders);
extracted coefficients, which are read off one operator call each, at the
same atol times their scale.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.ops.stencil_apply import (
    stencil_apply as jstencil_apply,
    stencil_transpose_planes as jtranspose)
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu.train import stencil as jst
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.ops import stencil_apply as k4
from diffnet_tpu_torch.pde import Poisson2D
from diffnet_tpu_torch.train import linear
from diffnet_tpu_torch.train import stencil as tst


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _rand(rng, shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=2e-6 * max(1.0, float(np.abs(b).max())))


SHAPES = [(2, 33, 33), (1, 40, 56), (3, 17, 129)]


@pytest.mark.parametrize("shared_c", [False, True])
@pytest.mark.parametrize("B,ny,nx", SHAPES)
def test_apply_matches_jax_kernel(B, ny, nx, shared_c):
    """K4's wrapper on CPU tensors (its plain version) against the JAX
    Pallas apply; a batch-1 C goes through JAX's ``stencil_matvec``
    route, which broadcasts it to the batch."""
    rng = np.random.default_rng(0)
    C = _rand(rng, (9, 1 if shared_c else B, ny, nx))
    u = _rand(rng, (B, ny, nx))
    want = jst.stencil_matvec(jnp.asarray(C), jnp.asarray(u), nsd=2,
                              kernel="dma")
    before = k4.launches
    got = k4.stencil_apply(torch.from_numpy(C), torch.from_numpy(u))
    assert k4.launches == before   # the plain version launches nothing
    _close(got, want)
    _close(k4.stencil_apply_plain(torch.from_numpy(C), torch.from_numpy(u)),
           want)


@pytest.mark.parametrize("shape", [(2, 17, 17), (1, 9, 23)])
def test_transpose_planes_match_jax(shape):
    rng = np.random.default_rng(2)
    C = _rand(rng, (9,) + shape)
    got = k4.stencil_transpose_planes(torch.from_numpy(C), 2)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jtranspose(jnp.asarray(C), 2)))


@pytest.mark.parametrize("shared_c", [False, True])
@pytest.mark.parametrize("B,ny,nx", SHAPES)
def test_autograd_matches_jax_vjp(B, ny, nx, shared_c):
    """du (the apply of the transposed planes) and dC (g times shifted u)
    against the JAX custom VJP; a batch-1 C sums its cotangent over the
    batch, as JAX's broadcast does."""
    rng = np.random.default_rng(3)
    C = _rand(rng, (9, 1 if shared_c else B, ny, nx))
    u, g = _rand(rng, (B, ny, nx)), _rand(rng, (B, ny, nx))
    jg = jnp.asarray(g)

    def jloss(C, u):
        return jnp.sum(jst.stencil_matvec(C, u, nsd=2, kernel="dma") * jg)

    gC_j, gu_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(C),
                                                 jnp.asarray(u))
    tC = torch.tensor(C, requires_grad=True)
    tu = torch.tensor(u, requires_grad=True)
    (k4.stencil_apply(tC, tu) * torch.from_numpy(g)).sum().backward()
    _close(tu.grad, gu_j)
    _close(tC.grad, gC_j)


def test_apply_rejects_what_the_kernel_does_not_take():
    C, u = torch.zeros(9, 2, 5, 6), torch.zeros(2, 5, 6)
    with pytest.raises(ValueError, match="nsd must be 2 or 3"):
        k4.stencil_apply(torch.zeros(81, 1, 3, 3, 3, 3),
                         torch.zeros(1, 3, 3, 3, 3), nsd=4)
    with pytest.raises(ValueError, match="C must be"):   # 2D planes, 3D u
        k4.stencil_apply(torch.zeros(9, 1, 4, 4, 4), torch.zeros(1, 4, 4, 4),
                         nsd=3)
    with pytest.raises(ValueError, match="C must be"):
        k4.stencil_apply(C[:, :, :, :5], u)
    with pytest.raises(ValueError, match="C must be"):
        k4.stencil_apply(torch.zeros(9, 3, 5, 6), u)
    with pytest.raises(TypeError, match="float32"):
        k4.stencil_apply(C.double(), u.double())
    with pytest.raises(ValueError, match="contiguous"):
        k4.stencil_apply(C, torch.zeros(2, 6, 5).transpose(1, 2))
    with pytest.raises(ValueError, match="not supported"):
        k4.apply_2d(C.to("meta"), u.to("meta"))


# ------------------------------------------------ extraction on a module ----

class _VarNuDS:
    """One variable-nu instance, source left / sink right, zero forcing."""

    def __init__(self, nu):
        ny, nx = nu.shape[-2:]
        bc1 = np.zeros((ny, nx)); bc1[:, 0] = 1
        bc2 = np.zeros((ny, nx)); bc2[:, -1] = 1
        self.inputs = np.stack([nu, bc1, bc2], -1).astype(np.float32)
        self.forcing = np.zeros((ny, nx, 1), np.float32)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def _nu(n, seed=4):
    rng = np.random.default_rng(seed)
    return np.exp(0.7 * rng.standard_normal((n, n))).astype(np.float32)


def _operators(n, deg=1, batch=None, **kw):
    """The affine-free Galerkin operator A(u) = R(u) - R(0) of the same
    variable-nu Poisson2D in both packages (per-sample nu with `batch`)."""
    nus = (np.stack([_nu(n, 4 + b) for b in range(batch)]) if batch
           else _nu(n))
    ds = _VarNuDS(nus[0] if batch else nus)
    args = dict(domain_size=n, batch_size=1, loss_type="resmin",
                fem_basis_deg=deg)
    jm = JPoisson2D(JDirectField((n, n)), ds, **args)
    tm = Poisson2D(DirectField((n, n)), ds, **args, **kw)
    inputs = np.broadcast_to(ds.inputs, (batch or 1,) + ds.inputs.shape).copy()
    if batch:
        inputs[..., 0] = nus
    forcing = np.zeros(inputs.shape[:-1] + (1,), np.float32)
    ji, jf = jnp.asarray(inputs), jnp.asarray(forcing)
    ti, tf = torch.from_numpy(inputs), torch.from_numpy(forcing)
    shape = (batch, n, n) if batch else (n, n)

    def lead(u):
        return u if batch else u[None]

    def unlead(r):
        return r if batch else r[0]

    jb0 = jm.residual_for_field(lead(jnp.zeros(shape)), ji, jf)
    tb0 = tm.residual_for_field(lead(torch.zeros(shape)), ti, tf)

    def jA(u):
        return unlead(jm.residual_for_field(lead(u), ji, jf) - jb0)

    def tA(u):
        return unlead(tm.residual_for_field(lead(u), ti, tf) - tb0)

    return jA, tA, shape


@pytest.mark.parametrize("batch", [None, 2])
def test_extract_stencil_matches_jax(batch):
    """extract_stencil of a variable-nu Galerkin operator at 17², one
    operator and a batch of per-sample operators."""
    jA, tA, shape = _operators(17, batch=batch)
    Cj = jst.extract_stencil(jA, shape, nsd=2)
    Ct = tst.extract_stencil(tA, shape, nsd=2, device="cpu")
    assert tuple(Ct.shape) == (9,) + shape
    _close(Ct, Cj)
    np.testing.assert_array_equal(np.asarray(tst.stencil_diag(Ct, nsd=2)),
                                  np.asarray(Ct[4]))
    _close(tst.stencil_diag(Ct, nsd=2), jst.stencil_diag(Cj, nsd=2))
    # the stencil reproduces the operator
    u = _rand(np.random.default_rng(5), shape)
    _close(tst.stencil_matvec(Ct, torch.from_numpy(u), nsd=2),
           tA(torch.from_numpy(u)))


def test_extract_from_a_module_on_the_k1_path():
    """A is called with one field a probe, so a module whose residual runs
    K1 (``fused_kernels=True``; its plain version here) is probed as the
    element path is."""
    _, tA, shape = _operators(17)
    _, tAk, _ = _operators(17, fused_kernels=True)
    _close(tst.extract_stencil(tAk, shape, device="cpu"),
           tst.extract_stencil(tA, shape, device="cpu"))


def test_extract_verified_and_assemble_match_jax():
    jA, tA, shape = _operators(17)
    Cj, dj = jst.extract_verified(jA, shape)
    Ct, dt = tst.extract_verified(tA, shape, device="cpu")
    _close(Ct, Cj)
    assert dj < 1e-5 and dt < 1e-5, (dj, dt)

    rng = np.random.default_rng(6)
    rhs = _rand(rng, shape)

    def jres(u):
        return jA(u) - jnp.asarray(rhs)

    def tres(u):
        return tA(u) - torch.from_numpy(rhs)

    mv_j, b_j, C_j = jst.assemble_stencil(jres, shape)
    mv_t, b_t, C_t = tst.assemble_stencil(tres, shape, device="cpu")
    _close(C_t, C_j)
    _close(b_t, b_j)
    u = _rand(rng, shape)
    _close(mv_t(torch.from_numpy(u)), mv_j(jnp.asarray(u)))


def test_deg2_needs_width_5():
    """deg-2 elements couple 3 nodes per axis: width 5 extracts them
    exactly (as in JAX), width 3 is rejected by the defect check."""
    jA, tA, shape = _operators(17, deg=2)
    Cj, dj = jst.extract_verified(jA, shape, width=5)
    Ct, dt = tst.extract_verified(tA, shape, width=5, device="cpu")
    assert Ct.shape[0] == 25
    _close(Ct, Cj)
    assert dt < 1e-5, dt
    with pytest.raises(ValueError, match="width-3 stencil"):
        tst.assemble_stencil(tA, shape, width=3, device="cpu")
    _, d3 = tst.extract_verified(tA, shape, width=3, device="cpu")
    _, d3j = jst.extract_verified(jA, shape, width=3)
    assert d3 > 1e-2 and d3j > 1e-2, (d3, d3j)


def test_kernel_cuda_on_cpu_tensors_is_the_plain_path():
    rng = np.random.default_rng(7)
    C = torch.from_numpy(_rand(rng, (9, 2, 3, 11, 13)))
    u = torch.from_numpy(_rand(rng, (2, 3, 11, 13)))
    want = tst.stencil_matvec(C, u, nsd=2)
    got = tst.stencil_matvec(C, u, nsd=2, kernel="cuda")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # one plane for every leading index
    C1 = C[:, :1, :1].contiguous()
    np.testing.assert_array_equal(
        np.asarray(tst.stencil_matvec(C1, u, nsd=2, kernel="cuda")),
        np.asarray(tst.stencil_matvec(C1, u, nsd=2)))
    with pytest.raises(ValueError, match="width-3"):
        tst.stencil_matvec(torch.zeros(25, 9, 9), torch.zeros(9, 9), width=5,
                           kernel="cuda")
    # 27-point (K4-3D's wrapper): the plain path too
    C3 = torch.from_numpy(_rand(rng, (27, 2, 5, 6, 7)))
    u3 = torch.from_numpy(_rand(rng, (2, 5, 6, 7)))
    np.testing.assert_array_equal(
        np.asarray(tst.stencil_matvec(C3, u3, nsd=3, kernel="cuda")),
        np.asarray(tst.stencil_matvec(C3, u3, nsd=3)))


@pytest.mark.parametrize("name", ["dma", "blockspec", "dmaf", "triton"])
def test_tpu_variant_names_raise(name):
    C, u = torch.zeros(9, 9, 9), torch.zeros(9, 9)
    with pytest.raises(ValueError, match="cuda"):
        tst.stencil_matvec(C, u, kernel=name)
    with pytest.raises(ValueError, match="cuda"):
        linear.solve_linear(lambda v: v, (9, 9), assemble="stencil",
                            stencil_kernel=name, device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        linear.multigrid_preconditioner(lambda n: None, 9,
                                        stencil_kernel=name, device="cpu")
