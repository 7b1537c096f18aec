"""The port's basis tables and FEM engine (diffnet_tpu_torch.core) against
the JAX package's (diffnet_tpu.core), on the same numpy inputs.

Tolerances: the tables must be equal (the port copies the numpy code);
float32 contractions and assemblies at atol=2e-6 (O(1) inputs, float32
sums in different orders), scaled by the largest entry where it exceeds 1
(second-derivative values grow as 1/h^2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnet_tpu.core import fem as jfem
from diffnet_tpu.core import quadrature as jq
from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core import quadrature as tq

BASES = [(2, 1, (0.1, 0.25)), (2, 2, (0.05, 0.05)), (3, 1, (0.1, 0.2, 0.3)),
         (1, 3, (0.5,))]


@pytest.mark.parametrize("nsd,deg,h", BASES)
def test_basis_tables_equal(nsd, deg, h):
    jb, tb = jq.make_basis(nsd, deg, h), tq.make_basis(nsd, deg, h)
    assert set(jb.tables) == set(tb.tables)
    for q in jb.tables:
        np.testing.assert_array_equal(tb.tables[q], jb.tables[q])
    for q in jb.surf_tables:
        np.testing.assert_array_equal(tb.surf_tables[q], jb.surf_tables[q])
    np.testing.assert_array_equal(tb.jxw, jb.jxw)
    np.testing.assert_array_equal(tb.gp_1d, jb.gp_1d)
    assert (tb.h, tb.jac, tb.ngp_1d) == (jb.h, jb.jac, jb.ngp_1d)


def _pair(nsd, deg, h):
    jb = jq.make_basis(nsd, deg, h)
    return jb, fem.BasisTables(tq.make_basis(nsd, deg, h))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("shape,deg", [((2, 17, 17), 1), ((1, 9, 13), 1),
                                       ((2, 17, 9), 2)])
def test_gp_eval_matches_jax(shape, deg):
    ny, nx = shape[1:]
    h = (1 / (nx - 1), 1 / (ny - 1))
    jb, tb = _pair(2, deg, h)
    u = np.random.default_rng(0).random(shape, np.float32)
    qs = ("N", "dx", "dy", "d2x", "d2y", "d2xy")
    jg = jfem.gp_eval(jnp.asarray(u), jb, qs)
    tg = fem.gp_eval(_t(u), tb, qs)
    for q in qs:
        np.testing.assert_allclose(tg[q].numpy(), np.asarray(jg[q]),
                                   atol=2e-6 * max(1.0, float(np.abs(
                                       jg[q]).max())))


@pytest.mark.parametrize("shape,deg", [((2, 17, 17), 1), ((2, 17, 9), 2)])
def test_galerkin_project_and_multi_match_jax(shape, deg):
    ny, nx = shape[1:]
    h = (1 / (nx - 1), 1 / (ny - 1))
    jb, tb = _pair(2, deg, h)
    nel = ((ny - 1) // deg, (nx - 1) // deg)
    rng = np.random.default_rng(1)
    a = rng.random(shape[:1] + nel + (jb.ngp_total,), np.float32)
    b = rng.random(nel + (jb.ngp_total,), np.float32)   # broadcast over B
    for q in ("N", "dx", "dy"):
        np.testing.assert_allclose(
            fem.galerkin_project(_t(a), tb, q, (ny, nx)).numpy(),
            np.asarray(jfem.galerkin_project(jnp.asarray(a), jb, q,
                                             (ny, nx))), atol=2e-6)
    terms_j = [(jnp.asarray(a), "dx"), (jnp.asarray(b), "N")]
    terms_t = [(_t(a), "dx"), (_t(b), "N")]
    np.testing.assert_allclose(
        fem.galerkin_project_multi(terms_t, tb, (ny, nx)).numpy(),
        np.asarray(jfem.galerkin_project_multi(terms_j, jb, (ny, nx))),
        atol=2e-6)


@pytest.mark.parametrize("nsd,deg,node_shape", [(2, 1, (9, 13)),
                                                (2, 2, (9, 5)),
                                                (3, 1, (5, 7, 9))])
def test_gather_and_scatter_match_jax(nsd, deg, node_shape):
    rng = np.random.default_rng(2)
    u = rng.random((2,) + node_shape, np.float32)
    jp = jfem.gather_elements(jnp.asarray(u), deg, nsd)
    tp = fem.gather_elements(_t(u), deg, nsd)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    r = rng.random(tuple(jp.shape), np.float32)
    np.testing.assert_allclose(
        fem.scatter_elements(_t(r), deg, nsd, node_shape).numpy(),
        np.asarray(jfem.scatter_elements(jnp.asarray(r), deg, nsd,
                                         node_shape)), atol=2e-6)


@pytest.mark.parametrize("node_shape", [(9, 13), (5, 5, 7)])
def test_gp_coords_and_element_tensor_equal(node_shape):
    nsd = len(node_shape)
    h = tuple(1.0 / (n - 1) for n in node_shape[::-1])
    jb, tb = jq.make_basis(nsd, 1, h), tq.make_basis(nsd, 1, h)
    for a, b in zip(fem.gp_coords(tb, node_shape),
                    jfem.gp_coords(jb, node_shape)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fem.element_tensor(tb),
                                  jfem.element_tensor(jb))


@pytest.mark.parametrize("deg,with_terms", [(1, False), (1, True),
                                            (2, True)])
def test_element_action_matches_jax(deg, with_terms):
    n = 17
    jb, tb = _pair(2, deg, (1 / (n - 1),) * 2)
    rng = np.random.default_rng(3)
    u, nu = (rng.random((2, n, n), np.float32) for _ in range(2))
    nel = (n - 1) // deg
    f = rng.random((nel, nel, jb.ngp_total), np.float32)
    A = jfem.element_tensor(jb)
    jt = [(jnp.asarray(-f), "N")] if with_terms else []
    tt = [(_t(-f), "N")] if with_terms else []
    Rj = jfem.element_action(jnp.asarray(u), jnp.asarray(nu), A, jb, (n, n),
                             gp_terms=jt)
    Rt = fem.element_action(_t(u), _t(nu), A, tb, (n, n), gp_terms=tt)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=2e-6)


def test_dirichlet_zero_rows_matches_jax():
    rng = np.random.default_rng(4)
    R = rng.random((2, 9, 9), np.float32)
    bc = rng.random((9, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        fem.dirichlet_zero_rows(_t(R), _t(bc)).numpy(),
        np.asarray(jfem.dirichlet_zero_rows(jnp.asarray(R), jnp.asarray(bc))))


def test_basis_tables_stay_out_of_state_dict():
    tb = fem.BasisTables(tq.make_basis(2, 1, (0.5, 0.5)))
    assert dict(tb.state_dict()) == {}
    assert tb.table("dx", torch.float32).dtype == torch.float32
    np.testing.assert_array_equal(tb.table("dx", torch.float64).numpy(),
                                  tb.basis.tables["dx"])
