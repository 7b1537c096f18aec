"""The port's convergence study against scripts/convergence_study.py on
the CPU, its two slowest rows: Stokes PSPG at 17^2 and the 3D Poisson
resmin at 9^3 (plain, and through K5's plain version).

Tolerances: the 3D error within 5e-3 relative of JAX's after 3 epochs
(both at the grid's discretisation error). Stokes converges slowly (the
JAX script's 400 epochs reach 5.7e-3 at 17^2 in both): after 40 epochs
both are mid-way and their LBFGS runs part, so the port's error lies
within 1.15x of JAX's either way (3.7% apart on a CPU)."""

import pytest

from tests.test_torch_studies import jax_script, one_torch_thread  # noqa: F401

REL = 5e-3
STOKES_FACTOR = 1.15


@pytest.fixture(scope="module")
def jcs():
    return jax_script("convergence_study")


@pytest.fixture(scope="module")
def pcs():
    from diffnet_tpu_torch.examples import convergence_study

    return convergence_study


@pytest.fixture(scope="module")
def jax_poisson3d(jcs):
    return jcs.solve_poisson3d(9, epochs=3)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_solve_poisson3d_matches_jax(pcs, jax_poisson3d, fused):
    ref = jax_poisson3d
    got = pcs.solve_poisson3d(9, epochs=3, device="cpu",
                              fused_kernels=fused)
    assert abs(got - ref) <= REL * ref, (got, ref)


def test_solve_stokes_matches_jax(jcs, pcs):
    ref = jcs.solve_stokes(17, epochs=40)
    got = pcs.solve_stokes(17, epochs=40, device="cpu")
    assert ref / STOKES_FACTOR <= got <= STOKES_FACTOR * ref, (got, ref)
