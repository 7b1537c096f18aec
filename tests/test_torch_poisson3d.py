"""The port's 3D Poisson path (``FEM3DModule``, ``Poisson3D``, K5's plain
version and autograd, the 3D datasets and ``write_vti``) against the JAX
package's, on the same numpy inputs.

The JAX Pallas K5 op runs in interpret mode (the monkeypatch of
tests/test_pallas_kernel.py); the port's K5 wrapper runs its plain version
on the CPU. Tolerances: fields at atol 2e-6 times max(1, max |ref|) (O(1)
float32 stencils summed in another order, the JAX kernel tests' own
tolerance); losses at rtol 1e-5 (float32 sums over ~1e4 terms); loss
gradients, whose entries reach O(100), at 1e-5 of their largest entry;
tables and coordinates, which both packages compute in float64 numpy, at
1e-12. Trainer parity: Adam step by step at rtol 1e-5, LBFGS by the final
L2 error within 10% (both run optax's L-BFGS, whose float32 runs part
within a few updates).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffnet_tpu.core import fem as jfem
from diffnet_tpu.core.quadrature import make_basis as jmake_basis
from diffnet_tpu.data import single_instances as jdata
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.ops import poisson_residual_3d as jk5
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu.pde.poisson import Poisson3D as JPoisson3D
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu.utils.vti import write_vti as jwrite_vti
from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.data import single_instances as tdata
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.ops import poisson_residual_3d as k5
from diffnet_tpu_torch.pde import FEM3DModule, Poisson2D, Poisson3D
from diffnet_tpu_torch.train import Callback, Trainer
from diffnet_tpu_torch.utils import write_vti


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _close(a, b, atol=2e-6):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=atol * max(1.0, float(np.abs(b).max())))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


# ---- FEM3DModule ------------------------------------------------------------

@pytest.mark.parametrize("sizes,lengths,deg", [
    ((9, 9, 9), (1.0, 1.0, 1.0), 1),
    ((17, 17, 20), (0.7, 0.7, 1.9), 1),
    ((9, 9, 13), (1.0, 1.0, 1.0), 2)])
def test_fem3d_tables_and_coordinates_match_jax(sizes, lengths, deg):
    kw = dict(domain_sizes=sizes, domain_lengths=lengths, fem_basis_deg=deg,
              loss_type="resmin")
    jm = JPoisson3D(None, **kw)
    tm = Poisson3D(None, **kw)
    assert isinstance(tm, FEM3DModule)
    assert tm.node_shape == jm.node_shape == sizes[::-1]
    assert (tm.nelemX, tm.nelemY, tm.nelemZ) == (jm.nelemX, jm.nelemY,
                                                 jm.nelemZ)
    for name in ("hx", "hy", "hz", "jxw", "gpw", "xgp", "ygp", "zgp", "xx",
                 "yy", "zz"):
        np.testing.assert_allclose(np.asarray(getattr(tm, name)),
                                   np.asarray(getattr(jm, name)), rtol=0,
                                   atol=1e-12, err_msg=name)
    for q, t in jm.basis.tables.items():
        np.testing.assert_allclose(tm.basis.table(q, torch.float64).numpy(),
                                   np.asarray(t), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="domain_sizeZ"):
        Poisson3D(None, domain_sizes=(9, 9, 10), fem_basis_deg=2)


def _inputs_3d(n, rng, batch=2):
    """(inputs [B, n, n, n, 3], forcing [B, n, n, n, 1]): a positive random
    nu, CuboidManufactured's wall masks, a random forcing."""
    ds = jdata.CuboidManufactured(n)
    inputs = np.broadcast_to(ds[0][0], (batch,) + ds[0][0].shape).copy()
    inputs[..., 0] = 0.5 + rng.random((batch, n, n, n))
    forcing = rng.random((batch, n, n, n, 1)).astype(np.float32)
    return inputs, forcing


def _mms():
    ds = jdata.CuboidManufactured
    return dict(exact_solution=ds.exact, forcing=ds.forcing_func,
                mms_dirichlet=True)


LOSS_CASES = {
    "energy": dict(loss_type="energy"),
    "energy-gpw": dict(loss_type="energy", energy_weighting="gpw"),
    "resmin-et": dict(loss_type="resmin"),
    "resmin-gp": dict(loss_type="resmin", residual_formulation="gp"),
    "resmin-mms": dict(loss_type="resmin", **_mms()),
    "strong-deg2": dict(loss_type="strong", fem_basis_deg=2),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_poisson3d_losses_and_gradients_match_jax(case):
    n = 9
    kw = dict(domain_size=n, **LOSS_CASES[case])
    jm, tm = JPoisson3D(None, **kw), Poisson3D(None, **kw)
    rng = np.random.default_rng(0)
    inputs, forcing = _inputs_3d(n, rng)
    u = rng.random((2, n, n, n)).astype(np.float32)
    lj, gj = jax.value_and_grad(lambda u: jm.loss(
        u, jnp.asarray(inputs), jnp.asarray(forcing)))(jnp.asarray(u))
    tu = _t(u, True)
    lt = tm.loss(tu, _t(inputs), _t(forcing))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5 * float(jnp.max(jnp.abs(gj))))
    if LOSS_CASES[case]["loss_type"] == "resmin":
        Rj = jm.residual_for_field(jnp.asarray(u), jnp.asarray(inputs),
                                   jnp.asarray(forcing))
        Rt = tm.residual_for_field(_t(u), _t(inputs), _t(forcing))
        _close(Rt.detach(), Rj)


def test_calc_l2_err_takes_three_coordinates():
    n = 9
    kw = dict(domain_size=n, loss_type="resmin", **_mms())
    jm, tm = JPoisson3D(None, **kw), Poisson3D(None, **kw)
    u = np.random.default_rng(1).random((n, n, n)).astype(np.float32)
    for a, b in zip(tm.calc_l2_err(_t(u)), jm.calc_l2_err(jnp.asarray(u))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


# ---- K5: the 3D stiffness action --------------------------------------------

def _h(shape, aniso):
    nz, ny, nx = shape
    if aniso:
        return (0.7 / (nx - 1), 1.9 / (ny - 1), 1.3 / (nz - 1))
    return (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1))


def _bases(shape, aniso=False):
    h = _h(shape, aniso)
    return jmake_basis(3, 1, h=h), fem.BasisTables(make_basis(3, 1, h=h))


def _K3_xla(u, nu, jb, shape):
    gp = jfem.gp_eval(u, jb, ("dx", "dy", "dz"))
    nug = jfem.gp_eval(nu, jb, ("N",))["N"]
    return sum(jfem.galerkin_project(nug * gp[q], jb, q, shape)
               for q in ("dx", "dy", "dz"))


K5_CASES = [((2, 9, 9, 9), True), ((2, 17, 17, 17), False),
            ((2, 20, 17, 17), False)]


@pytest.mark.parametrize("shape,aniso", K5_CASES)
def test_stiffness3d_plain_matches_jax(shape, aniso):
    """K5's plain version (the wrapper on CPU tensors, no launch) against
    the JAX Pallas op and the XLA assembly; rectangular z included."""
    jb, tb = _bases(shape[1:], aniso)
    rng = np.random.default_rng(2)
    u, nu = (rng.random(shape, np.float32) for _ in range(2))
    before = k5.launches
    Kt = k5.poisson_stiffness_action_3d(_t(u), _t(nu), tb)
    assert k5.launches == before
    Kp = jk5.poisson_stiffness_action_3d(jnp.asarray(u), jnp.asarray(nu), jb)
    Kx = _K3_xla(jnp.asarray(u), jnp.asarray(nu), jb, shape[1:])
    _close(Kt, Kp)
    _close(Kt, Kx)


@pytest.mark.parametrize("shape,aniso", [((1, 9, 9, 9), True),
                                         ((2, 20, 17, 17), False)])
def test_stiffness3d_vjp_matches_jax(shape, aniso):
    jb, tb = _bases(shape[1:], aniso)
    rng = np.random.default_rng(3)
    u, nu, g = (rng.random(shape, np.float32) for _ in range(3))
    gj = jax.grad(lambda u, nu: jnp.sum(
        jk5.poisson_stiffness_action_3d(u, nu, jb) * g),
        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(nu))
    tu, tnu = _t(u, True), _t(nu, True)
    (k5.poisson_stiffness_action_3d(tu, tnu, tb) * _t(g)).sum().backward()
    _close(tu.grad, gj[0])
    _close(tnu.grad, gj[1])


@pytest.mark.parametrize("batched_mask", [False, True])
def test_residual_fused_3d_matches_jax(batched_mask):
    shape = (2, 9, 9, 9)
    jb, tb = _bases(shape[1:], aniso=True)
    rng = np.random.default_rng(4)
    u, nu, Nf = (rng.random(shape, np.float32) for _ in range(3))
    bc = jdata.CuboidManufactured(9).bc2.astype(np.float32)
    if batched_mask:
        bc = np.stack([bc, (rng.random(shape[1:]) > 0.7).astype(np.float32)])
    Rj = jk5.poisson_residual_fused_3d(*(jnp.asarray(a)
                                         for a in (u, nu, Nf, bc)), jb)
    Rt = k5.poisson_residual_fused_3d(_t(u), _t(nu), _t(Nf), _t(bc), tb)
    _close(Rt, Rj)
    with pytest.raises(ValueError, match="broadcast"):
        k5.poisson_residual_fused_3d(_t(u), _t(nu[:1]), _t(Nf), _t(bc), tb)


def _k5_body_f64(u, nu, consts):
    """A float64 transcription of csrc/poisson3d.cu's element body (the
    Gauss pair's sum/difference basis), term for term, assembled as the
    kernel's walk sums: the upper plane's part of element plane z - 1 and
    the lower plane's of plane z in the transformed basis, then the x and y
    inverse, then the left element's part and the part of the row above."""
    c00, c01, _, _, wx2, wy2, wz2 = consts
    g = (c00 - c01) ** 2
    w = {a: (s / 16, s / 16 * g, s / 16 * g * g)
         for a, s in (("x", wx2), ("y", wy2), ("z", wz2))}

    def xy_stage(p):   # a node plane's corners -> [sy][sx]
        v = [[p[..., j:p.shape[-2] - 1 + j, i:p.shape[-1] - 1 + i]
              for i in (0, 1)] for j in (0, 1)]
        s0, d0 = v[0][0] + v[0][1], v[0][1] - v[0][0]
        s1, d1 = v[1][0] + v[1][1], v[1][1] - v[1][0]
        return [[s0 + s1, d0 + d1], [s1 - s0, d1 - d0]]

    def product(U, N):
        ng01, ng10, ng11 = g * N[0][1], g * N[1][0], g * N[1][1]
        return [[U[0][0] * N[0][0] + U[0][1] * ng01 + U[1][0] * ng10
                 + U[1][1] * g * ng11,
                 U[0][0] * N[0][1] + U[0][1] * N[0][0] + U[1][0] * ng11
                 + U[1][1] * ng10],
                [U[0][0] * N[1][0] + U[1][0] * N[0][0] + U[0][1] * ng11
                 + U[1][1] * ng01,
                 U[0][0] * N[1][1] + U[1][1] * N[0][0] + U[0][1] * N[1][0]
                 + U[1][0] * N[0][1]]]

    tu, tn = xy_stage(u), xy_stage(nu)   # [sy][sx], each [B, nz, ...]
    uh = [[[f(tu[j][i]) for i in (0, 1)] for j in (0, 1)]
          for f in (lambda t: t[:, :-1] + t[:, 1:],
                    lambda t: t[:, 1:] - t[:, :-1])]
    nh = [[[f(tn[j][i]) for i in (0, 1)] for j in (0, 1)]
          for f in (lambda t: t[:, :-1] + t[:, 1:],
                    lambda t: t[:, 1:] - t[:, :-1])]
    Tx = product([[uh[a][b][1] for b in (0, 1)] for a in (0, 1)],
                 [[nh[a][b][0] for b in (0, 1)] for a in (0, 1)])
    Ty = product([[uh[a][1][b] for b in (0, 1)] for a in (0, 1)],
                 [[nh[a][0][b] for b in (0, 1)] for a in (0, 1)])
    Tz = product([[uh[1][a][b] for b in (0, 1)] for a in (0, 1)],
                 [[nh[0][a][b] for b in (0, 1)] for a in (0, 1)])
    c001, c010, c100 = (w["x"][0] * Tx[0][0], w["y"][0] * Ty[0][0],
                        w["z"][0] * Tz[0][0])
    c011 = w["x"][1] * Tx[0][1] + w["y"][1] * Ty[0][1]
    c101 = w["x"][1] * Tx[1][0] + w["z"][1] * Tz[0][1]
    c110 = w["y"][1] * Ty[1][0] + w["z"][1] * Tz[1][0]
    c111 = (w["x"][2] * Tx[1][1] + w["y"][2] * Ty[1][1]
            + w["z"][2] * Tz[1][1])
    P0 = [[-c100, c001 - c101], [c010 - c110, c011 - c111]]
    P1 = [[c100, c001 + c101], [c010 + c110, c011 + c111]]
    pad = torch.nn.functional.pad
    Q = [[pad(P0[j][i], (0, 0, 0, 0, 0, 1)) + pad(P1[j][i], (0, 0, 0, 0, 1, 0))
          for i in (0, 1)] for j in (0, 1)]
    r00, r01 = Q[0][0] - Q[0][1], Q[0][0] + Q[0][1]
    r10, r11 = Q[1][0] - Q[1][1], Q[1][0] + Q[1][1]
    a = [[r00 - r10, r01 - r11], [r00 + r10, r01 + r11]]
    return sum(pad(a[j][i], (i, 1 - i, j, 1 - j))
               for j in (0, 1) for i in (0, 1))


@pytest.mark.parametrize("shape,aniso", [((2, 9, 9, 9), True),
                                         ((1, 10, 12, 12), False)])
def test_k5_body_transcription_matches_the_plain_version(shape, aniso):
    """The algebra of the CUDA kernel's element body, rehearsed in float64
    on the CPU: within 1e-12 (relative to the largest entry) of the plain
    version, which follows the JAX package's sum-factorised algebra."""
    tb = fem.BasisTables(make_basis(3, 1, h=_h(shape[1:], aniso)))
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.random(shape) - 0.3)
    nu = torch.from_numpy(rng.random(shape) + 0.5)
    got = _k5_body_f64(u, nu, k5.stiffness_consts_3d(tb.basis))
    want = k5.stiffness_action_3d_plain(u, nu, tb.to(torch.float64))
    assert got.dtype == want.dtype == torch.float64
    _close(got, want, atol=1e-12)


@pytest.mark.parametrize("shape,tz", [
    ((1, 129, 129, 129), 15), ((4, 64, 64, 64), 8), ((1, 128, 128, 128), 16),
    ((1, 65, 65, 65), 2), ((1, 33, 33, 33), 1), ((1, 17, 17, 17), 1),
    ((2, 9, 9, 9), 1), ((2, 20, 17, 17), 1), ((1, 9, 45, 45), 1),
    ((2, 3, 17, 17), 1)])
def test_k5_strip_fills_the_card(shape, tz):
    """K5's strip on an H100's 132 SMs, at the shapes its callers and
    chip_smoke.py use: the longest setting whose launch still gives each SM
    its warps, split evenly over the planes, at most 31 planes."""
    sms = 132
    B, nz, ny, nx = shape
    got = k5.strip_planes(*shape, sms)
    assert got == tz
    strips = -(-nz // got)
    assert 1 <= got <= k5.STRIPS[0] and (strips - 1) * got < nz
    blocks = B * -(-(nx - 1) // k5.COLS) * -(-ny // (k5.WARPS - 1))
    setting = min(s for s in k5.STRIPS if s >= got)
    assert -(-nz // setting) == strips
    assert all(blocks * -(-nz // s) * k5.WARPS < k5.MIN_WARPS_PER_SM * sms
               for s in k5.STRIPS if s > setting)


def test_wrapper_3d_rejects_what_the_kernel_does_not_take():
    _, tb = _bases((5, 5, 5))
    x = torch.zeros(2, 5, 5, 5)
    with pytest.raises(ValueError, match="ny == nx"):
        k5.stiffness_action_3d(torch.zeros(1, 5, 4, 5),
                               torch.zeros(1, 5, 4, 5), tb)
    with pytest.raises(TypeError, match="float32"):
        k5.stiffness_action_3d(x.double(), x.double(), tb)
    with pytest.raises(ValueError, match="contiguous"):
        k5.stiffness_action_3d(x, x.transpose(2, 3), tb)
    with pytest.raises(ValueError, match="shape"):
        k5.stiffness_action_3d(x, x[:1], tb)
    with pytest.raises(ValueError, match=r"\[B, nz, ny, nx\]"):
        k5.stiffness_action_3d(x[0], x[0], tb)
    with pytest.raises(ValueError, match="not supported"):
        k5.stiffness_action_3d(x.to("meta"), x.to("meta"), tb)
    with pytest.raises(ValueError, match="deg-1 3D"):
        k5.stiffness_consts_3d(make_basis(3, 2, h=(0.1,) * 3))


# ---- Poisson3D(fused_kernels=True) ------------------------------------------

def test_poisson3d_fused_loss_and_gradient_match_jax():
    """The counterpart of tests/test_pallas_kernel.py's fused-flag test: the
    port's K5 route (plain version here) against the JAX fused and unfused
    modules, in the loss, its gradient and residual_for_field."""
    n = 9
    ds = jdata.CuboidManufactured(n)
    kw = dict(domain_size=n, loss_type="resmin")
    jm0 = JPoisson3D(JDirectField((n,) * 3), ds, **kw)
    jm1 = JPoisson3D(JDirectField((n,) * 3), ds, fused_kernels=True, **kw)
    tm = Poisson3D(DirectField((n,) * 3), ds, fused_kernels=True, **kw)
    inputs, forcing = (a[None] for a in ds[0])
    rng = np.random.default_rng(13)
    u = rng.random((1, n, n, n)).astype(np.float32)
    ji, jf = jnp.asarray(inputs), jnp.asarray(forcing)
    tu = _t(u, True)
    before = k5.launches
    lt = tm.loss(tu, _t(inputs), _t(forcing))
    lt.backward()
    assert k5.launches == before
    for jm in (jm0, jm1):
        lj, gj = jax.value_and_grad(lambda u: jm.loss(u, ji, jf))(
            jnp.asarray(u))
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
        np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-5 * float(jnp.max(jnp.abs(gj))))
    _close(tm.residual_for_field(_t(u), _t(inputs), _t(forcing)),
           jm1.residual_for_field(jnp.asarray(u), ji, jf))


def test_fused_flags_reject_unsupported_configs():
    """tests/test_pallas_kernel.py's ValueErrors, in both packages: 3D fused
    supports resmin only (energy is the default loss), deg 1 only, and the
    single-launch loss+grad is 2D only."""
    for P, D in ((JPoisson3D, JDirectField), (Poisson3D, DirectField)):
        with pytest.raises(ValueError, match="3D resmin only"):
            P(D((9, 9, 9)), domain_size=9, fused_kernels=True)
        with pytest.raises(ValueError, match="3D resmin only"):
            P(D((9, 9, 9)), domain_size=9, fem_basis_deg=2,
              loss_type="resmin", fused_kernels=True)
        with pytest.raises(ValueError, match="nsd=2"):
            P(D((9, 9, 9)), domain_size=9, loss_type="resmin",
              fused_kernels=True, fused_loss_grad=True)
    for P, D in ((JPoisson2D, JDirectField), (Poisson2D, DirectField)):
        with pytest.raises(ValueError):
            P(D((25, 25)), domain_size=25, fem_basis_deg=2,
              fused_kernels=True)


# ---- Trainer on 3D MMS ------------------------------------------------------

def _mms_modules(n, init, **kw):
    jds, tds = jdata.CuboidManufactured(n), tdata.CuboidManufactured(n)
    jds.n_samples = tds.n_samples = 1
    kw = dict(domain_size=n, batch_size=1, loss_type="resmin", **_mms(), **kw)
    return (JPoisson3D(JDirectField((n,) * 3, init=init), jds, **kw),
            Poisson3D(DirectField((n,) * 3, init=init), tds,
                      fused_kernels=True, **kw))


class _Losses:
    def __init__(self):
        self.losses = []

    def on_train_start(self, *a):
        pass

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])

    def on_train_end(self, *a):
        pass


class _JLosses(_Losses, JCallback):
    pass


class _TLosses(_Losses, Callback):
    pass


def test_adam_3d_matches_jax_trainer():
    n = 9
    init = np.random.default_rng(5).random((n,) * 3).astype(np.float32)
    jm, tm = _mms_modules(n, init)
    jcb, tcb = _JLosses(), _TLosses()
    jst = JTrainer(max_epochs=4, optimizer="adam", learning_rate=1e-3,
                   callbacks=[jcb]).fit(jm)
    tst = Trainer(max_epochs=4, optimizer="adam", learning_rate=1e-3,
                  callbacks=[tcb], device="cpu").fit(tm)
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=1e-5)
    np.testing.assert_allclose(tst.params["field"].numpy(),
                               np.asarray(jst.params["field"]), rtol=1e-5)


def test_lbfgs_3d_mms_final_l2_matches_jax_trainer():
    """examples/poisson_3d.py's MMS run at 9^3, 20 LBFGS epochs: the port's
    fused-kernel module (plain K5 here) reaches the JAX Trainer's L2
    error."""
    n = 9
    jm, tm = _mms_modules(n, np.zeros((n,) * 3))
    jst = JTrainer(max_epochs=20, optimizer="lbfgs", lbfgs_max_iter=10).fit(jm)
    Trainer(max_epochs=20, optimizer="lbfgs", lbfgs_max_iter=10,
            device="cpu").fit(tm)
    eL2, _, uex = jm.calc_l2_err(jm.network.apply(jst.params)[0])
    rel_j = float(eL2 / uex)
    with torch.no_grad():
        eL2, _, uex = tm.calc_l2_err(tm.network()[0])
    rel_t = float(eL2 / uex)
    assert abs(rel_t - rel_j) <= 0.1 * rel_j, (rel_t, rel_j)


# ---- 3D datasets and the VTI writer -----------------------------------------

@pytest.mark.parametrize("name", ["Cuboid", "CuboidManufactured"])
def test_cuboid_datasets_match_jax(name):
    jd, td = getattr(jdata, name)(9), getattr(tdata, name)(9)
    assert len(jd) == len(td)
    for a, b in zip(td[0], jd[0]):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if name == "CuboidManufactured":
        x = np.linspace(0, 1, 5)
        np.testing.assert_array_equal(td.exact(x, x, x), jd.exact(x, x, x))


def _write_voxels(prefix, vox):
    nx, ny, nz = vox.shape
    with open(f"{prefix}VoxelConfig.txt", "w") as f:
        f.write("voxel config\n-0.5 -0.25 0.0\n0.5 0.25 1.0\n")
        f.write(f"{nx} {ny} {nz}\n0.1 0.1 0.1\n")
    (vox * 254).astype(np.uint8).ravel(order="F").tofile(f"{prefix}inouts.raw")


def test_voxel_raw_loading_matches_jax(tmp_path):
    """A synthetic voxelisation (the repo ships no .raw asset), larger than
    the embedding window along z so the clip is exercised."""
    vox = (np.random.default_rng(6).random((5, 6, 10)) > 0.5).astype(float)
    prefix = str(tmp_path / "obj_")
    _write_voxels(prefix, vox)
    for a, b in zip(tdata.load_raw(prefix), jdata.load_raw(prefix)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdata.load_raw(prefix)[0], vox)
    jd = jdata.VoxelIMBackRAW(prefix, domain_size=16, offset=8)
    td = tdata.VoxelIMBackRAW(prefix, domain_size=16, offset=8)
    for a, b in zip(td[0], jd[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(5, 7), (3, 4, 6)])
@pytest.mark.parametrize("kw", [{}, {"ascii_mode": False},
                                {"as_celldata": True}])
def test_write_vti_matches_jax(tmp_path, shape, kw):
    field = np.random.default_rng(7).random(shape)
    write_vti(str(tmp_path / "t.vti"), field, **kw)
    jwrite_vti(str(tmp_path / "j.vti"), field, **kw)
    got, want = ((tmp_path / f).read_bytes() for f in ("t.vti", "j.vti"))
    assert got == want
    with pytest.raises(ValueError, match="2D or 3D"):
        write_vti(str(tmp_path / "x.vti"), np.zeros(4))
