"""The port's flow slice against the JAX package, on the CPU.

Each function takes the same numpy inputs on both sides. Tolerances: tau at
1e-6 relative (one sqrt and a divide in float32); the VMS residuals, their
VJP and JVP at 2e-5 x max(1, max |ref|), the JAX package's own tolerance
between its kernel and its XLA path (tests/test_pallas_kernel.py); the
module residuals and losses at 1e-5 (losses relative), as the JAX package
holds its fused module path; solved fields at 1e-4 (float32 Krylov solves
whose matvecs sum in another order; JAX measured 6e-8 between its own fused
and XLA Newton solves); Adam losses at 1e-5 relative, as the Poisson
trainer test; LBFGS by its final loss only (both run optax's L-BFGS,
whose float32 runs part within a few updates).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import diffnet_tpu.ops.ns_residual as jnr
from diffnet_tpu.core.quadrature import make_basis as jmake_basis
from diffnet_tpu.data import flow as jflow
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde import flow as jpf
from diffnet_tpu.train import linear as jlin
from diffnet_tpu.train.trainer import Callback as JCallback
from diffnet_tpu.train.trainer import Trainer as JTrainer
from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.data import flow as tflow
from diffnet_tpu_torch.interop import params_from_jax
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.ops import ns_residual as tnr
from diffnet_tpu_torch.pde import flow as tpf
from diffnet_tpu_torch.train import Callback, Trainer
from diffnet_tpu_torch.train import linear as tlin

VISCO = 0.01


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    """JAX's Pallas kernels run in interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol=0.0, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _scaled_close(got, want, tol=2e-5):
    want = np.asarray(want)
    _close(got, want, atol=tol * max(1.0, float(np.abs(want).max())))


def _bases(n, aniso=False):
    h = (0.7 / (n - 1), 1.9 / (n - 1)) if aniso else (1 / (n - 1),) * 2
    return jmake_basis(2, 1, h=h), fem.BasisTables(make_basis(2, 1, h=h))


def _fields(n, k, seed, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.random((batch, n, n)).astype(np.float32) for _ in range(k)]


def test_calc_tau_matches_jax():
    rng = np.random.default_rng(0)
    u, v = (rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
            for _ in range(2))
    for h in (0.05, (0.03, 0.07)):
        jt = jpf.calc_tau(h, jnp.asarray(u), jnp.asarray(v), VISCO)
        tt = tpf.calc_tau(h, _t(u), _t(v), VISCO)
        for a, b in zip(tt, jt):
            _close(a, b, rtol=1e-6)


@pytest.mark.parametrize("n,with_f,aniso", [(33, False, False),
                                            (40, True, False),
                                            (65, False, False),
                                            (33, True, True)])
def test_plain_residual_matches_xla(n, with_f, aniso):
    jb, tb = _bases(n, aniso)
    u, v, p, fx, fy = _fields(n, 5, seed=5)
    if not with_f:
        fx = fy = None
    want = jnr.ns_vms_residual_xla(
        *(None if a is None else jnp.asarray(a) for a in (u, v, p, fx, fy)),
        jb, VISCO)
    got = tnr.ns_vms_residual_plain(
        *(None if a is None else _t(a) for a in (u, v, p, fx, fy)), tb, VISCO)
    for a, b in zip(got, want):
        _scaled_close(a, b)


@pytest.mark.parametrize("variant", ["dma", "blockspec"])
def test_fused_op_matches_the_tpu_kernel_in_interpret_mode(variant):
    """The port's op on CPU tensors against JAX's Pallas kernel itself,
    run in interpret mode, at 33^2 with 16-row tiles."""
    n = 33
    jb, tb = _bases(n)
    u, v, p = _fields(n, 3, seed=5)
    want = jnr._ns_fwd_impl(*map(jnp.asarray, (u, v, p)), None, None, jb,
                            VISCO, 16, variant)
    got = tnr.ns_vms_residual_fused(_t(u), _t(v), _t(p), None, None, tb,
                                    VISCO)
    for a, b in zip(got, want):
        _scaled_close(a, b)


def _weights(n, seed):
    return _fields(n, 3, seed, batch=1)


@pytest.mark.parametrize("with_f", [False, True])
def test_vjp_matches_jax_grad(with_f):
    n = 33
    jb, tb = _bases(n)
    xs = _fields(n, 5 if with_f else 3, seed=6, batch=1)
    w = _weights(n, 7)

    def jloss(*a):
        fx, fy = (a[3], a[4]) if with_f else (None, None)
        R = jnr.ns_vms_residual_fused(a[0], a[1], a[2], fx, fy, jb, VISCO,
                                      16)
        return sum(jnp.sum(r * ww) for r, ww in zip(R, w))

    jax_grads = jax.grad(jloss, argnums=tuple(range(len(xs))))(
        *map(jnp.asarray, xs))
    txs = [_t(a).requires_grad_(True) for a in xs]
    fx, fy = (txs[3], txs[4]) if with_f else (None, None)
    R = tnr.ns_vms_residual_fused(txs[0], txs[1], txs[2], fx, fy, tb, VISCO)
    sum((r * _t(ww)).sum() for r, ww in zip(R, w)).backward()
    for a, b in zip(txs, jax_grads):
        _scaled_close(a.grad, b)


def test_jvp_matches_jax_jvp_in_both_forward_modes():
    """The Jacobian action Newton-Krylov takes, through torch.func.jvp and
    through forward_ad dual tensors, against jax.jvp of JAX's fused op
    (interpret mode)."""
    n = 33
    jb, tb = _bases(n)
    u, v, p, du, dv, dp = _fields(n, 6, seed=8, batch=1)
    Pj, Tj = jax.jvp(
        lambda *a: jnr.ns_vms_residual_fused(*a, None, None, jb, VISCO, 16),
        tuple(map(jnp.asarray, (u, v, p))), tuple(map(jnp.asarray,
                                                      (du, dv, dp))))

    def fn(*a):
        return tnr.ns_vms_residual_fused(*a, None, None, tb, VISCO)

    with torch.no_grad():   # as inside the Krylov solve
        Pt, Tt = torch.func.jvp(fn, tuple(map(_t, (u, v, p))),
                                tuple(map(_t, (du, dv, dp))))
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        Td = [fwAD.unpack_dual(r).tangent for r in fn(*(
            fwAD.make_dual(_t(a), _t(b))
            for a, b in ((u, du), (v, dv), (p, dp))))]
    for got, want in ((Pt, Pj), (Tt, Tj), (Td, Tj)):
        for a, b in zip(got, want):
            _scaled_close(a, b)


def test_plain_jvp_drops_the_tangent_of_tau():
    """tau carries no tangent (JAX's stop_gradient): the written-out
    tangent equals torch.func.jvp through the plain version, and differs
    from the tangent of the same algebra with tau differentiated."""
    n = 17
    _, tb = _bases(n, aniso=True)
    xs = tuple(map(_t, _fields(n, 5, seed=9, batch=1)))
    ts = tuple(map(_t, _fields(n, 5, seed=10, batch=1)))
    got = tnr.ns_vms_residual_plain_jvp(xs, ts, tb, VISCO)
    _, want = torch.func.jvp(
        lambda *a: tnr.ns_vms_residual_plain(*a, tb, VISCO), xs, ts)
    for a, b in zip(got, want):
        _scaled_close(a, b, 1e-6)

    def tau_not_detached(h, u, v, visco):
        Gxx, Gyy = 4.0 / h[0]**2, 4.0 / h[1]**2
        t = torch.sqrt(Gxx * u**2 + Gyy * v**2
                       + 36.0 * visco**2 * (Gxx**2 + Gyy**2))
        return 1.0 / t, t / (Gxx + Gyy)

    orig = tnr.calc_tau
    try:
        tnr.calc_tau = tau_not_detached
        _, undetached = torch.func.jvp(
            lambda *a: tnr.ns_vms_residual_plain(*a, tb, VISCO), xs, ts)
    finally:
        tnr.calc_tau = orig
    assert max(float((a - b).abs().max())
               for a, b in zip(got, undetached)) > 1e-4


def _raises_case(case):
    n = 17
    _, tb = _bases(n)
    u, v, p = (torch.rand(1, n, n) for _ in range(3))
    visco = VISCO
    if case == "shapes":
        v = torch.rand(2, n, n)
    elif case == "visco":
        visco = 0.0
    elif case == "rectangular":
        u, v, p = (torch.rand(1, n, n + 8) for _ in range(3))
        tb = fem.BasisTables(make_basis(2, 1, h=(1 / (n + 7), 1 / (n - 1))))
    elif case == "deg2":
        tb = fem.BasisTables(make_basis(2, 2, h=(1 / 8, 1 / 8)))
    elif case == "float64":
        u, v, p = (x.double() for x in (u, v, p))
    elif case == "device":
        u, v, p = (torch.zeros(1, n, n, device="meta") for _ in range(3))
    return u, v, p, tb, visco


def _kernel_body_f64(u, v, p, fx, fy, basis, visco):
    """A float64 transcription of csrc/ns2d.cu's element body (each
    symmetric Gauss pair in sum/difference form), term for term, with the
    constants of ``ns_consts``; assembled as the kernel's lanes sum their
    corners."""
    from diffnet_tpu_torch.ops.poisson_residual import assemble_corners

    (h, h2, nkx, kxh, nky, kyh, visco, gxx, gyy, diff, isum_g, wq, wh, wh2,
     ax, ay, bx, by) = tnr.ns_consts(basis.basis, visco)

    def corners(a):
        return (a[..., :-1, :-1], a[..., :-1, 1:], a[..., 1:, :-1],
                a[..., 1:, 1:])

    def gauss(a):   # N[gx][gy], dx[gy], dy[gx]
        c0, c1, c2, c3 = corners(a)
        e, f, g1, g2 = c0 + c3, c1 + c2, c0 - c3, c1 - c2
        hab, q = e - f, 0.25 * (e + f)
        mp, mm = h2 * hab + q, -h2 * hab + q
        N = [[h * g1 + mp, -h * g2 + mm], [h * g2 + mm, -h * g1 + mp]]
        tx, ty = nkx * (g1 - g2), nky * (g1 + g2)
        return N, [-kxh * hab + tx, kxh * hab + tx], \
            [-kyh * hab + ty, kyh * hab + ty]

    (uN, ux, uy), (vN, vx, vy), (pN, px, py) = (gauss(a) for a in (u, v, p))
    zero = [[0.0, 0.0], [0.0, 0.0]]
    f1N, f2N = (zero, zero) if fx is None else (gauss(fx)[0], gauss(fy)[0])
    # integrands at each Gauss point [gy][gx]: against N, dN/dx, dN/dy
    IN, IX, IY = ([[[None] * 2 for _ in range(2)] for _ in range(3)]
                  for _ in range(3))
    for gx in (0, 1):
        for gy in (0, 1):
            uu, vv, pp = uN[gx][gy], vN[gx][gy], pN[gx][gy]
            dudx, dvdx, dpdx = ux[gy], vx[gy], px[gy]
            dudy, dvdy, dpdy = uy[gx], vy[gx], py[gx]
            div = dudx + dvdy
            adv1 = uu * dudx + (vv * dudy - f1N[gx][gy])
            adv2 = uu * dvdx + (vv * dvdy - f2N[gx][gy])
            res1, res2 = adv1 + dpdx, adv2 + dpdy
            s2 = gxx * uu * uu + (gyy * vv * vv + diff)
            taum = torch.rsqrt(s2)
            tcd = (s2 * taum) * (isum_g * div)
            tm1, tm2 = taum * res1, taum * res2
            um, vm = uu - tm1, vv - tm2
            IN[0][gy][gx] = -tm2 * dudy + (-tm1 * dudx + adv1)
            IN[1][gy][gx] = -tm2 * dvdy + (-tm1 * dvdx + adv2)
            IN[2][gy][gx] = div
            IX[0][gy][gx] = (um * tm1 + (visco * dudx - pp)) + tcd
            IX[1][gy][gx] = visco * dvdx + um * tm2
            IX[2][gy][gx] = tm1
            IY[0][gy][gx] = visco * dudy + vm * tm1
            IY[1][gy][gx] = (vm * tm2 + (visco * dvdy - pp)) + tcd
            IY[2][gy][gx] = tm2
    out = []
    for r in range(3):
        i0, i1, i2, i3 = IN[r][0][0], IN[r][0][1], IN[r][1][0], IN[r][1][1]
        e, f, g1, g2 = i0 + i3, i1 + i2, i0 - i3, i1 - i2
        X0, X1 = IX[r][0][0] + IX[r][0][1], IX[r][1][0] + IX[r][1][1]
        Y0, Y1 = IY[r][0][0] + IY[r][1][0], IY[r][0][1] + IY[r][1][1]
        sx, dx, sy, dy = X0 + X1, X0 - X1, Y0 + Y1, Y0 - Y1
        q = wh2 * (e - f) + (-bx * dx + -by * dy)
        w0 = wq * (e + f)
        mp, mm = w0 + q, w0 - q
        sp = wh * g1 + (-ax * sx + -ay * sy)
        sm = -wh * g2 + (-ax * sx + ay * sy)
        out.append(assemble_corners(mp + sp, mm - sm, mm + sm, mp - sp))
    return out


@pytest.mark.parametrize("n,with_f,aniso", [(9, False, True),
                                            (12, True, False),
                                            (17, True, True)])
def test_kernel_body_transcription_matches_the_plain_version(n, with_f,
                                                             aniso):
    """The algebra of the CUDA kernel's element body, rehearsed in float64
    on the CPU: within 1e-12 (relative to the largest entry) of the plain
    version, which follows the JAX package's XLA path."""
    h = (0.7 / (n - 1), 1.9 / (n - 1)) if aniso else (1 / (n - 1),) * 2
    tb = fem.BasisTables(make_basis(2, 1, h=h)).to(torch.float64)
    rng = np.random.default_rng(n)
    xs = [torch.from_numpy(rng.random((2, n, n)) - 0.3) for _ in range(5)]
    fx, fy = (xs[3], xs[4]) if with_f else (None, None)
    got = _kernel_body_f64(*xs[:3], fx, fy, tb, VISCO)
    want = tnr.ns_vms_residual_plain(*xs[:3], fx, fy, tb, VISCO)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        _close(a, b.numpy(), atol=1e-12 * float(b.abs().max()))


def test_strip_rows_fill_the_card():
    """K6's strip: the longest that still gives each SM its warps; one
    element row a lane on a grid as small as 129^2."""
    sms = 132
    assert tnr.strip_rows(8, 512, 512, sms) == 7
    assert tnr.strip_rows(8, 256, 256, sms) == 5
    assert tnr.strip_rows(1, 129, 129, sms) == tnr.STRIPS[-1] == 1
    for B, n in ((1, 65), (2, 257), (4, 1000)):
        ty = tnr.strip_rows(B, n, n, sms)
        cols = B * -(-n // tnr.COLS)
        assert all(cols * -(-n // (tnr.WARPS * t - 1)) * tnr.WARPS
                   < tnr.MIN_WARPS_PER_SM * sms
                   for t in tnr.STRIPS if t > ty)


@pytest.mark.parametrize("case,err", [("shapes", ValueError),
                                      ("visco", ValueError),
                                      ("rectangular", ValueError),
                                      ("deg2", ValueError),
                                      ("float64", TypeError),
                                      ("device", ValueError)])
def test_dispatch_raises_on_what_the_kernel_does_not_take(case, err):
    u, v, p, tb, visco = _raises_case(case)
    with pytest.raises(err):
        tnr.ns_vms_residual(u, v, p, None, None, tb, visco)
    with pytest.raises(err):
        tnr.ns_vms_residual_fused(u, v, p, None, None, tb, visco)


# ---- the modules ----------------------------------------------------------

def _ldc_inputs(n):
    m = np.zeros((n, n), np.float32)
    m[[0, -1], :] = 1.0
    m[:, [0, -1]] = 1.0
    pin = np.zeros((n, n), np.float32)
    pin[0, 0] = 1.0
    return np.stack([np.zeros((n, n), np.float32)] * 2 + [m, m, pin],
                    -1)[None]


def _module_pair(kind, n=17, **kw):
    if kind == "stokes":
        J, T = jpf.StokesMMS, tpf.StokesMMS
        kw.setdefault("Re", 1.0)
    else:
        J, T = jpf.NavierStokes, tpf.NavierStokes
        u_bc, v_bc, p_bc = jpf.ldc_bcs((n, n))
        kw = dict(dict(Re=100.0, u_bc=u_bc, v_bc=v_bc, p_bc=p_bc), **kw)
    fused = kw.pop("fused_kernels", False)
    return (J(JDirectField((n, n), n_fields=3), domain_size=n, **kw),
            T(DirectField((n, n), n_fields=3), domain_size=n,
              fused_kernels=fused, **kw))


@pytest.mark.parametrize("kind,fused,deg", [("ns", False, 1),
                                            ("ns", True, 1),
                                            ("ns", False, 2),
                                            ("stokes", False, 1)])
def test_module_residuals_and_losses_match_jax(kind, fused, deg):
    n = 17
    jm, tm = _module_pair(kind, n, fem_basis_deg=deg, fused_kernels=fused)
    pred = _fields(n, 3, seed=9, batch=1)
    inputs = _ldc_inputs(n)
    jR = jm.calc_residuals(tuple(map(jnp.asarray, pred)),
                           jnp.asarray(inputs), None)
    tR = tm.calc_residuals(tuple(map(_t, pred)), _t(inputs), None)
    for a, b in zip(tR, jR):
        _close(a, b, atol=1e-5)
    for norm in ("frobenius", "squared"):
        jm.loss_norm = tm.loss_norm = norm
        _close(tm.loss(tuple(map(_t, pred)), _t(inputs), None),
               jm.loss(tuple(map(jnp.asarray, pred)), jnp.asarray(inputs),
                       None), rtol=1e-5)


def test_fused_flag_rejects_unsupported_configs():
    with pytest.raises(ValueError, match="fused_kernels"):
        tpf.StokesMMS(None, domain_size=9, fused_kernels=True)
    with pytest.raises(ValueError, match="fused_kernels"):
        tpf.NavierStokes(None, domain_size=9, fused_kernels=True,
                         forcing=lambda x, y: (x, y))
    with pytest.raises(ValueError, match="fused_kernels"):
        tpf.NavierStokes(None, domain_size=9, fem_basis_deg=2,
                         fused_kernels=True)
    with pytest.raises(ValueError, match="nonlinear"):
        tpf.NavierStokes(None, domain_size=9).residual_for_field(
            None, None, None)


def test_mixed_residual_mean_control_gauge_matches_jax():
    n = 17
    for kind in ("ns", "stokes"):
        jm, tm = _module_pair(kind, n)
        f = dict(zip("uvp", _fields(n, 3, seed=11, batch=1)))
        inputs = _ldc_inputs(n)
        jR = jm.mixed_residual({k: jnp.asarray(a) for k, a in f.items()},
                               jnp.asarray(inputs), None)
        tR = tm.mixed_residual({k: _t(a) for k, a in f.items()},
                               _t(inputs), None)
        for k in "uvp":
            _close(tR[k], jR[k], atol=1e-5)


def test_mixed_residual_dirichlet_gauge_on_the_fps_channel():
    kw = dict(domain_sizes=(25, 13), Re=30)
    jds = jflow.NSFPSChannelDataset(**kw)
    tds = tflow.NSFPSChannelDataset(**kw)
    inputs, _ = tds[0]
    mk = dict(domain_sizes=(25, 13), domain_lengths=(12.0, 6.0), Re=30.0,
              u_bc=tds.u_bc, v_bc=tds.v_bc, p_bc=tds.p_bc,
              pressure_gauge="dirichlet")
    jm = jpf.NavierStokes(None, jds, **mk)
    tm = tpf.NavierStokes(None, tds, **mk)
    rng = np.random.default_rng(12)
    f = {k: rng.random((1, 13, 25)).astype(np.float32) for k in "uvp"}
    jR = jm.mixed_residual({k: jnp.asarray(a) for k, a in f.items()},
                           jnp.asarray(inputs)[None], None)
    tR = tm.mixed_residual({k: _t(a) for k, a in f.items()},
                           _t(inputs)[None], None)
    for k in "uvp":
        _close(tR[k], jR[k], atol=1e-5)
    assert float(tR["p"][0, :, -1].abs().max()) == 0.0   # real p rows


def test_weak_form_ldc_loss_matches_jax():
    n = 17
    rng = np.random.default_rng(13)
    pred = [rng.random((2, n, n)).astype(np.float32) for _ in range(3)]
    inputs = np.stack([rng.random((n, n))] + [
        (rng.random((n, n)) > 0.8).astype(np.float64) for _ in range(3)],
        -1).astype(np.float32)[None].repeat(2, 0)
    forcing = np.full((2, n, n, 1), 0.01, np.float32)
    jm = jpf.FlowWeakFormLDC(None, domain_size=n)
    tm = tpf.FlowWeakFormLDC(None, domain_size=n)
    _close(tm.loss(tuple(map(_t, pred)), _t(inputs), _t(forcing)),
           jm.loss(tuple(map(jnp.asarray, pred)), jnp.asarray(inputs),
                   jnp.asarray(forcing)), rtol=1e-5)


def test_datasets_match_jax():
    chis = jflow.synthetic_obstacles(3, shape=(9, 17), seed=1)
    for a, b in zip(tflow.synthetic_obstacles(3, shape=(9, 17), seed=1),
                    chis):
        np.testing.assert_array_equal(a, b)
    pairs = [(jflow.StokesMMSDataset(9), tflow.StokesMMSDataset(9)),
             (jflow.NSLDCDataset(domain_sizes=(11, 9), Re=100),
              tflow.NSLDCDataset(domain_sizes=(11, 9), Re=100)),
             (jflow.FlowPastObjectDataset(chis[0]),
              tflow.FlowPastObjectDataset(chis[0])),
             (jflow.NSFPSChannelDataset(domain_sizes=(25, 13)),
              tflow.NSFPSChannelDataset(domain_sizes=(25, 13))),
             (jflow.FlowPastObjectEnsemble(chis),
              tflow.FlowPastObjectEnsemble(chis))]
    for jd, td in pairs:
        assert len(jd) == len(td)
        for k in (0, len(jd) - 1):
            for a, b in zip(td[k], jd[k]):
                np.testing.assert_array_equal(a, b)
        for attr in ("u_bc", "v_bc", "p_bc"):
            if hasattr(jd, attr):
                np.testing.assert_array_equal(getattr(td, attr),
                                              getattr(jd, attr))
    with pytest.raises(IndexError):
        tflow.FlowPastObjectEnsemble(chis)[3]


# ---- the solvers ----------------------------------------------------------

def test_stokes_linear_solve_matches_jax():
    n = 17
    jds, tds = jflow.StokesMMSDataset(n), tflow.StokesMMSDataset(n)
    jds.n_samples = tds.n_samples = 1
    jsol, _ = jlin.stokes_linear_solve(
        jpf.StokesMMS(None, jds, domain_size=n, batch_size=1, Re=1),
        maxiter=100)
    m = tpf.StokesMMS(None, tds, domain_size=n, batch_size=1, Re=1)
    tsol, info = tlin.stokes_linear_solve(m, maxiter=100, device="cpu")
    for a, b in zip(tsol, jsol):
        _close(a, b, atol=1e-4)
    # the module route gives the same solve, and rejects scalar-path knobs
    rsol, _ = tlin.module_linear_solve(m, tol=1e-6, device="cpu")
    for a, b in zip(rsol, tsol):
        _close(a, b, atol=1e-6)
    with pytest.raises(ValueError, match="stokes_linear_solve"):
        tlin.module_linear_solve(m, method="gmres", device="cpu")


def test_solve_linear_takes_a_mixed_template():
    """A dict template: residual, preconditioner and solution are dicts."""
    A = {"a": torch.tensor([[2.0, 3.0], [5.0, 4.0]]),
         "b": torch.tensor([[1.0, 6.0], [7.0, 8.0]])}
    rhs = {"a": torch.ones(2, 2), "b": torch.ones(2, 2)}
    sol, _ = tlin.solve_linear(
        lambda f: {k: A[k] * f[k] - rhs[k] for k in f},
        {k: torch.zeros(2, 2) for k in "ab"}, method="gmres", tol=1e-7,
        M=lambda r: {k: r[k] / A[k] for k in r}, device="cpu")
    for k in "ab":
        _close(sol[k], 1.0 / A[k].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="mixed"):
        tlin.solve_linear(lambda f: f, {"a": torch.zeros(2, 2)},
                          assemble="stencil", device="cpu")


def _ldc_pair(n, Re, fused=False):
    u_bc, v_bc, p_bc = jpf.ldc_bcs((n, n))
    out = []
    for mod, pde in ((jflow, jpf), (tflow, tpf)):
        ds = mod.NSLDCDataset(domain_sizes=(n, n), Re=Re)
        ds.n_samples = 1
        kw = dict(fused_kernels=True) if (pde is tpf and fused) else {}
        out.append(pde.NavierStokes(None, ds, domain_size=n, batch_size=1,
                                    Re=Re, u_bc=u_bc, v_bc=v_bc, p_bc=p_bc,
                                    **kw))
    return out


def test_ns_newton_solve_through_the_fused_op_matches_jax(monkeypatch):
    """17^2 LDC at Re 100: the port with fused_kernels=True (its Jacobian
    actions through the Function's jvp rule) against JAX's XLA-path solve,
    the pressure included (a constant drift of the gauge would pass |F|)."""
    n = 17
    jm, tm = _ldc_pair(n, 100.0, fused=True)
    jsol, jinfo = jlin.ns_newton_solve(jm, newton_iters=6)
    calls = []
    orig = tnr.ns_vms_residual_plain_jvp
    monkeypatch.setattr(tnr, "ns_vms_residual_plain_jvp",
                        lambda *a: calls.append(1) or orig(*a))
    tsol, tinfo = tlin.ns_newton_solve(tm, newton_iters=6, device="cpu")
    assert calls, "the Function's jvp rule never ran"
    assert tinfo["residual_history"][-1] < 1e-6, tinfo
    assert tinfo["newton_iters"] == jinfo["newton_iters"]
    for a, b in zip(tsol, jsol):
        _close(a, b, atol=1e-4)
    x = np.linspace(0, 1, n)
    _close(tsol[0][-1], 1 - 16 * (x - 0.5) ** 4, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(Re=1000.0, momentum_reaction="auto"),
                                dict(Re=400.0, lm0=1e-3)])
def test_newton_branches_follow_jax_residual_history(kw):
    """The reaction-shifted preconditioner and the Levenberg schedule, on a
    small budget (2 Newton iterations of 3 GMRES cycles)."""
    kw = dict(kw)
    jm, tm = _ldc_pair(17, kw.pop("Re"))
    budget = dict(newton_iters=2, gmres_iters=3, restart=10, **kw)
    _, jinfo = jlin.ns_newton_solve(jm, **budget)
    _, tinfo = tlin.ns_newton_solve(tm, device="cpu", **budget)
    assert tinfo["newton_iters"] == jinfo["newton_iters"]
    _close(tinfo["residual_history"], jinfo["residual_history"], rtol=1e-3)


def test_newton_solve_on_a_plain_tensor():
    """The generic solver on an array unknown: x^3 = 8 elementwise."""
    x, info = tlin.newton_solve(lambda x: x**3 - 8.0, torch.ones(3, 4),
                                newton_iters=20, tol=1e-5, device="cpu")
    _close(x, np.full((3, 4), 2.0), rtol=1e-5)
    assert info["residual_history"][-1] < 1e-5


# ---- training -------------------------------------------------------------

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


def test_params_from_jax_carries_a_three_field_direct_field():
    jp = JDirectField((5, 5), init=np.arange(25.0).reshape(5, 5),
                      n_fields=3).init(None)
    tp = params_from_jax({k: np.asarray(a) for k, a in jp.items()})
    net = DirectField((5, 5), n_fields=3)
    net.load_state_dict(tp)
    assert sorted(tp) == sorted(jp) == ["field_0", "field_1", "field_2"]
    for k in jp:
        _close(getattr(net, k), jp[k])


@pytest.mark.parametrize("fused", [False, True])
def test_adam_on_a_three_field_module_matches_jax_trainer(fused):
    n = 17
    jds = jflow.NSLDCDataset(domain_sizes=(n, n), Re=100)
    tds = tflow.NSLDCDataset(domain_sizes=(n, n), Re=100)
    jds.n_samples = tds.n_samples = 1
    u_bc, v_bc, p_bc = jpf.ldc_bcs((n, n))
    kw = dict(domain_size=n, batch_size=1, Re=100.0, u_bc=u_bc, v_bc=v_bc,
              p_bc=p_bc, loss_norm="squared")
    jm = jpf.NavierStokes(JDirectField((n, n), n_fields=3), jds, **kw)
    tm = tpf.NavierStokes(DirectField((n, n), n_fields=3), tds,
                          fused_kernels=fused, **kw)
    rng = np.random.default_rng(14)
    params = {f"field_{i}": rng.random((n, n)).astype(np.float32)
              for i in range(3)}
    jcb, tcb = _JLosses(), _TLosses()
    jst = JTrainer(max_epochs=3, optimizer="adam", learning_rate=1e-3,
                   callbacks=[jcb]).fit(
        jm, params={k: jnp.asarray(a) for k, a in params.items()})
    tst = Trainer(max_epochs=3, optimizer="adam", learning_rate=1e-3,
                  callbacks=[tcb], device="cpu").fit(
        tm, params=params_from_jax(params))
    _close(tcb.losses, jcb.losses, rtol=1e-5)
    for k in params:
        _close(tst.params[k], jst.params[k], rtol=1e-5, atol=1e-6)


def test_lbfgs_fit_of_the_cavity_lowers_the_loss():
    """examples/ns_ldc.py's configuration at 17^2 through the kernel path
    (plain versions on the CPU): the loss falls below 0.05x its first
    value, the bar of the JAX package's own NS training test."""
    n = 17
    _, tm = _ldc_pair(n, 100.0, fused=True)
    net = DirectField((n, n), init=np.zeros((n, n)), n_fields=3)
    m = tpf.NavierStokes(net, tm.dataset, **dict(
        domain_size=n, batch_size=1, Re=100.0, loss_norm="squared",
        fused_kernels=True, u_bc=tm.u_bc.numpy(), v_bc=tm.v_bc.numpy(),
        p_bc=tm.p_bc.numpy()))
    batch = tuple(_t(a)[None] for a in m.dataset[0])
    with torch.no_grad():
        first = float(m.training_loss(batch))
    Trainer(max_epochs=20, optimizer="lbfgs", lbfgs_max_iter=10,
            device="cpu").fit(m)
    with torch.no_grad():
        final = float(m.training_loss(batch))
        u = m.apply_bcs(m.network(batch[0]), batch[0])[0][0].numpy()
    assert final < 0.05 * first, (first, final)
    x = np.linspace(0, 1, n)
    _close(u[-1], 1 - 16 * (x - 0.5) ** 4, atol=1e-5)


def test_chip_smoke_and_the_jax_reference_script_build_one_problem():
    """chip_smoke.py's slice G1 holds the port to the figures of
    scripts/torch_port_reference_flow.py; each keeps its own copy of the
    problem (chip_smoke imports no JAX), so the two copies must agree."""
    import importlib.util
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference_flow",
        root / "scripts/torch_port_reference_flow.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert (chip_smoke.G1_GRID, chip_smoke.G1_RE,
            chip_smoke.G1_NEWTON_ITERS) == (ref.G1_GRID, ref.G1_RE,
                                            ref.G1_NEWTON_ITERS)
    n = 17
    tm = chip_smoke.ldc_module(n, True)
    jds = jflow.NSLDCDataset(domain_sizes=(n, n), Re=ref.G1_RE)
    for a, b in zip(tm.dataset[0], jds[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((tm.u_bc, tm.v_bc, tm.p_bc), jpf.ldc_bcs((n, n))):
        np.testing.assert_array_equal(a.numpy(), b)
    assert tm.Re == ref.G1_RE and tm.pressure_gauge == "mean-control"
    u, v, p = np.random.default_rng(15).random((3, n, n))
    assert chip_smoke.midline_figures(u, v, p) == ref.midline_figures(u, v, p)
    assert set(chip_smoke.JAX_G1) == set(ref.midline_figures(u, v, p)) | {
        "final_F", "newton_steps"}
