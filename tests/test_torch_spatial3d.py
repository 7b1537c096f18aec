"""The port's depth-sharded 3D Poisson stiffness action through K5
(diffnet_tpu_torch.parallel.poisson_stiffness_spatial_fused_3d) against
the JAX package's shard_map version on the 8-device virtual mesh
(tests/conftest.py) with ``space=4``, at its own test's 16^3.

One module-scoped spawn of 4 gloo ranks on the CPU
(tests/torch_parallel_ranks.py::spatial3d_rank) computes each rank's
planes; the tests stack them. The JAX path runs its Pallas kernel in
interpret mode (~15 s here, hence a file of its own).

Tolerances: fields and the VJPs at 2e-6 x max(1, max |ref|) (the kernel
tests' own for O(1) float32 stencils), the VJPs against autograd through
the port's unsharded K5.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffnet_tpu.core.quadrature import make_basis as jmake_basis
from diffnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffnet_tpu.parallel.spatial import (
    poisson_stiffness_spatial_fused_3d as jfused_spatial_3d)
from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.ops.poisson_residual_3d import (
    poisson_stiffness_action_3d)
from diffnet_tpu_torch.parallel import run_ranks
from tests import torch_parallel_ranks as ranks

WORLD = 4
# JAX's test case (test_pallas_kernel.py), and depth unlike the planes
SHAPES = {"cube16": (2, 16, 16, 16), "deep12": (1, 12, 9, 9)}


def _field_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * max(1.0, np.abs(want).max()))


def _h(shape):
    return tuple(1 / (s - 1) for s in shape[:0:-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(14)
    p = {"cases": {k: tuple(rng.random(s).astype(np.float32)
                            for _ in range(3)) for k, s in SHAPES.items()}}
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    out = run_ranks(ranks.spatial3d_rank, WORLD, (p,), init_method=init,
                    timeout=120.0, threads=1)
    return p, {k: tuple(np.concatenate([o[k][i] for o in out], axis=1)
                        for i in range(3)) for k in out[0]}


def test_spatial_k5_matches_jax(run):
    p, got = run
    u, nu, _ = p["cases"]["cube16"]
    mesh = jmake_mesh(space=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   partial(pl.pallas_call, interpret=True))
        want = np.asarray(jfused_spatial_3d(
            jnp.asarray(u), jnp.asarray(nu),
            jmake_basis(3, 1, h=_h(u.shape)), mesh, variant="blockspec",
            tile_z=8))
    _field_close(got["cube16"][0], want)


@pytest.mark.parametrize("case", list(SHAPES))
def test_spatial_k5_and_its_vjp_match_the_unsharded_op(run, case):
    """K u and the u and nu cotangents of <g, K(nu) u> over 4 depth slabs
    (K5's VJPs on the halo'd slabs, the exchange's backward returning the
    halo planes) against autograd through the unsharded K5."""
    p, got = run
    u, nu, g = (torch.tensor(a, requires_grad=True)
                for a in p["cases"][case])
    tb = fem.BasisTables(make_basis(3, 1, h=_h(u.shape)))
    R = poisson_stiffness_action_3d(u, nu, tb)
    (R * g.detach()).sum().backward()
    for i, want in enumerate((R.detach(), u.grad, nu.grad)):
        _field_close(got[case][i], want.numpy())
