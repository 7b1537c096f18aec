"""The port's convergence study against scripts/convergence_study.py on
the CPU, the 2D rows beyond Poisson and Stokes: Helmholtz, space-time
heat, SUPG advection-diffusion, space-time Burgers and Allen-Cahn, each
at its smallest --quick grid.

Tolerance: each relative L2 error within 5e-3 relative of JAX's, at a
budget where both packages' LBFGS have reached the grid's discretisation
error (3 epochs; advection-diffusion and Burgers 15)."""

import pytest

from tests.test_torch_studies import jax_script, one_torch_thread  # noqa: F401

REL = 5e-3

# (name, solver, grid, epochs)
CASES = [("helmholtz", "solve_helmholtz", 17, 3),
         ("spacetime-heat", "solve_spacetime", 9, 3),
         ("advdiff", "solve_advdiff", 17, 15),
         ("burgers", "solve_burgers", 9, 15),
         ("allen-cahn", "solve_allencahn", 9, 3)]


@pytest.fixture(scope="module")
def jcs():
    return jax_script("convergence_study")


@pytest.fixture(scope="module")
def pcs():
    from diffnet_tpu_torch.examples import convergence_study

    return convergence_study


@pytest.mark.parametrize("name,solver,n,epochs", CASES,
                         ids=[c[0] for c in CASES])
def test_solver_matches_jax(jcs, pcs, name, solver, n, epochs):
    ref = getattr(jcs, solver)(n, epochs=epochs)
    got = getattr(pcs, solver)(n, epochs=epochs, device="cpu")
    assert abs(got - ref) <= REL * ref, (name, got, ref)
