"""The port's Poisson2D (and the modules around it) against the JAX
package's, on the same numpy inputs.

The JAX Pallas ops run in interpret mode (same monkeypatch as
tests/test_pallas_kernel.py); the port's kernel ops run their plain
versions on the CPU. Tolerances: losses at rtol=1e-5 (float32 sums over
~1e3 terms in different orders); residual fields and u-gradients at 2e-6
of their largest entry where it exceeds 1 (O(1) float32 stencils).
"""

import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffnet_tpu.data.single_instances import (
    Rectangle as JRectangle, RectangleManufactured as JRectangleManufactured)
from diffnet_tpu.models.field import DirectField as JDirectField
from diffnet_tpu.pde.poisson import Poisson2D as JPoisson2D
from diffnet_tpu_torch.data.single_instances import (Rectangle,
                                                     RectangleManufactured)
from diffnet_tpu_torch.interop import params_from_jax
from diffnet_tpu_torch.models import DirectField
from diffnet_tpu_torch.pde import Poisson2D

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _exact(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y)


def _forcing(x, y):
    return 2 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y)


def _pair(n, mms=False, jax_kw=None, **kw):
    """A JAX and a port Poisson2D built alike (the JAX one with `jax_kw`
    instead of `kw` when given), and one batch as numpy."""
    if mms:
        kw.update(exact_solution=_exact, forcing=_forcing, mms_dirichlet=True)
    jds, tds = JRectangleManufactured(n), RectangleManufactured(n)
    jkw = kw if jax_kw is None else dict(kw, **jax_kw)
    jm = JPoisson2D(JDirectField((n, n)), jds, domain_size=n, **jkw)
    tm = Poisson2D(DirectField((n, n)), tds, domain_size=n, **kw)
    rng = np.random.default_rng(7)
    inputs, forcing = tds[0]
    inputs = np.stack([inputs, inputs])
    inputs[..., 0] = 0.5 + rng.random((2, n, n))      # variable nu
    forcing = np.stack([forcing, rng.random((n, n, 1)).astype(np.float32)])
    u = rng.random((2, n, n)).astype(np.float32)
    return jm, tm, u, inputs.astype(np.float32), forcing


def _close(a, b, rtol=None):
    a, b = np.asarray(a), np.asarray(b)
    if rtol is not None:
        np.testing.assert_allclose(a, b, rtol=rtol)
    else:
        np.testing.assert_allclose(a, b,
                                   atol=2e-6 * max(1.0, np.abs(b).max()))


def _loss_and_grad_both(jm, tm, u, inputs, forcing):
    ji, jf = jnp.asarray(inputs), jnp.asarray(forcing)
    lj, gj = jax.value_and_grad(lambda u: jm.loss(u, ji, jf))(jnp.asarray(u))
    tu = torch.tensor(u, requires_grad=True)
    lt = tm.loss(tu, torch.from_numpy(inputs), torch.from_numpy(forcing))
    lt.backward()
    return (lj, gj), (lt.detach(), tu.grad)


LOSS_CASES = [
    ("energy", {}),
    ("energy", {"fused_kernels": True}),
    ("energy", {"energy_weighting": "gpw"}),
    ("resmin", {}),
    ("resmin", {"residual_formulation": "gp"}),
    ("resmin", {"fused_kernels": True}),
    ("resmin", {"fused_kernels": True, "fused_loss_grad": True}),
    # the JAX K2 op fails on the [ny, nx] Nf of an MMS forcing (it pads Nf
    # as [B, ny, nx]), so this case is held to the unfused JAX loss
    ("resmin", {"fused_kernels": True, "fused_loss_grad": True, "mms": True,
                "jax_kw": {"fused_kernels": False,
                           "fused_loss_grad": False}}),
    ("resmin", {"mms": True}),
    ("energy", {"fused_kernels": True, "mms": True}),
]


@pytest.mark.parametrize("loss_type,kw", LOSS_CASES)
def test_loss_and_grad_match_jax(loss_type, kw):
    kw = dict(kw)
    mms = kw.pop("mms", False)
    jm, tm, u, inputs, forcing = _pair(17, mms=mms, loss_type=loss_type, **kw)
    (lj, gj), (lt, gt) = _loss_and_grad_both(jm, tm, u, inputs, forcing)
    _close(lt, lj, rtol=1e-5)
    _close(gt, gj)


def test_fused_flags_give_the_unfused_loss():
    for loss_type, extra in (("energy", {}),
                             ("resmin", {"fused_loss_grad": True})):
        _, t0, u, inputs, forcing = _pair(17, loss_type=loss_type)
        t1 = Poisson2D(DirectField((17, 17)), domain_size=17,
                       loss_type=loss_type, fused_kernels=True, **extra)
        args = (torch.from_numpy(u), torch.from_numpy(inputs),
                torch.from_numpy(forcing))
        _close(t1.loss(*args), t0.loss(*args), rtol=1e-5)


def test_resmin_precond_matches_jax():
    n = 9
    P = np.random.default_rng(8).random((n * n, n * n)).astype(np.float32)
    jm, tm, u, inputs, forcing = _pair(n, loss_type="resmin", precond=P)
    (lj, gj), (lt, gt) = _loss_and_grad_both(jm, tm, u, inputs, forcing)
    _close(lt, lj, rtol=1e-5)
    _close(gt, gj)


def test_strong_form_deg2_matches_jax():
    jm, tm, u, inputs, forcing = _pair(17, loss_type="strong",
                                       fem_basis_deg=2)
    (lj, gj), (lt, gt) = _loss_and_grad_both(jm, tm, u, inputs, forcing)
    _close(lt, lj, rtol=1e-5)
    _close(gt, gj)


@pytest.mark.parametrize("kw", [{}, {"residual_formulation": "gp"},
                                {"fused_kernels": True},
                                {"fused_kernels": True, "mms": True}])
def test_residual_for_field_matches_jax(kw):
    kw = dict(kw)
    mms = kw.pop("mms", False)
    jm, tm, u, inputs, forcing = _pair(17, mms=mms, loss_type="resmin", **kw)
    Rj = jm.residual_for_field(jnp.asarray(u), jnp.asarray(inputs),
                               jnp.asarray(forcing))
    Rt = tm.residual_for_field(torch.from_numpy(u), torch.from_numpy(inputs),
                               torch.from_numpy(forcing))
    _close(Rt, Rj)


def test_apply_bcs_and_l2_match_jax():
    jm, tm, u, inputs, _ = _pair(17, mms=True, loss_type="resmin")
    uj = jm.apply_bcs(jnp.asarray(u), jnp.asarray(inputs))
    ut = tm.apply_bcs(torch.from_numpy(u), torch.from_numpy(inputs))
    _close(ut, uj)
    for a, b in zip(tm.calc_l2_err(ut[0]), jm.calc_l2_err(uj[0])):
        _close(a, b, rtol=1e-5)


def test_rejects_unsupported_fused_configs():
    with pytest.raises(ValueError, match="fused_loss_grad"):
        Poisson2D(DirectField((17, 17)), domain_size=17, loss_type="resmin",
                  fused_loss_grad=True)
    with pytest.raises(ValueError, match="fused_loss_grad"):
        Poisson2D(DirectField((17, 17)), domain_size=17, fused_kernels=True,
                  loss_type="resmin", fused_loss_grad=True,
                  precond=np.eye(289))
    with pytest.raises(ValueError, match="fused_kernels"):
        Poisson2D(DirectField((17, 17)), domain_size=17, fused_kernels=True,
                  loss_type="strong")
    with pytest.raises(ValueError, match="jxw"):
        Poisson2D(DirectField((17, 17)), domain_size=17, fused_kernels=True,
                  energy_weighting="gpw")
    with pytest.raises(ValueError, match="fem_basis_deg"):
        Poisson2D(DirectField((16, 16)), domain_size=16, fem_basis_deg=2)


@pytest.mark.parametrize("n_fields", [1, 3])
def test_params_from_jax_direct_field(n_fields):
    """JAX DirectField params -> the port's state dict, same loss."""
    n = 17
    init = np.random.default_rng(9).random((n, n)).astype(np.float32)
    jnet = JDirectField((n, n), init=init, n_fields=n_fields)
    jparams = jax.tree.map(np.asarray, jnet.init(None))
    tnet = DirectField((n, n), n_fields=n_fields)
    tnet.load_state_dict(params_from_jax(jparams))
    names = ["field"] if n_fields == 1 else [f"field_{i}"
                                             for i in range(n_fields)]
    assert sorted(tnet.state_dict()) == sorted(names)
    jm, tm, _, inputs, forcing = _pair(n, loss_type="resmin")
    ju = jnet.apply(jparams, jnp.asarray(inputs))
    tu = tnet(torch.from_numpy(inputs))
    if n_fields > 1:
        ju, tu = ju[0], tu[0]
    lj = jm.loss(ju, jnp.asarray(inputs), jnp.asarray(forcing))
    lt = tm.loss(tu, torch.from_numpy(inputs), torch.from_numpy(forcing))
    _close(lt.detach(), lj, rtol=1e-5)


def test_datasets_match_jax():
    for jd, td in ((JRectangleManufactured(17), RectangleManufactured(17)),
                   (JRectangle(9), Rectangle(9))):
        assert len(jd) == len(td)
        for a, b in zip(td[0], jd[0]):
            np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax():
    """Importing every module of the port (the IBN slices' among them),
    and chip_smoke.py (without running its main), leaves jax and
    diffnet_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffnet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "for n in ('core.geometry', 'data.parametric', 'data.loader',\n"
        "          'models.networks', 'pde.ibn', 'train.query',\n"
        "          'train.trainer', 'utils.export', 'interop',\n"
        "          'models.pointnets', 'data.geometry_datasets',\n"
        "          'utils.mesh3d'):\n"
        "    assert 'diffnet_tpu_torch.' + n in names, n\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'diffnet_tpu', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
