"""Stochastic diffusivity-field generation via Karhunen-Loeve sums (a copy
of ``diffnet_tpu/data/gen_input.py``; numpy and scipy only).

Port of the reference generator (reference: DiffNet/gen_input_calc.py:4-181).
The eigenfrequencies omega_i solve the transcendental equation
``tan(omega) = 2*eta*omega / (eta^2 omega^2 - 1)`` of the exponential-kernel
KL eigenproblem on [0, 1]; instead of hardcoding tables for 5 eta values
(gen_input_calc.py:4-71), we solve for them numerically (brentq per branch),
matching the reference tables to ~1e-9 and supporting any eta > 0.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.optimize import brentq

__all__ = [
    "calculate_omega_based_on_eta",
    "construct_KL_sum_2D",
    "construct_KL_sum_3D",
    "grid2D",
    "grid3D",
    "generate_diffusivity_tensor",
    "sobol_coefficients",
]


@lru_cache(maxsize=32)
def calculate_omega_based_on_eta(eta: float, n_terms: int = 10) -> np.ndarray:
    """First `n_terms` KL eigenfrequencies for correlation length `eta`.

    Roots of f(w) = (eta^2 w^2 - 1) sin(w) - 2 eta w cos(w) on (0, inf),
    one per interval ((k-0.5)pi, (k+0.5)pi) excluding the poles.
    """
    eta = float(eta)

    def f(w):
        return (eta * eta * w * w - 1.0) * np.sin(w) - 2.0 * eta * w * np.cos(w)

    roots = []
    k = 0
    eps = 1e-9
    while len(roots) < n_terms:
        lo = k * np.pi + eps
        hi = (k + 1) * np.pi - eps
        if f(lo) * f(hi) < 0:
            roots.append(brentq(f, lo, hi, xtol=1e-13))
        else:
            # two roots or none in this pi-interval: scan finer
            grid = np.linspace(lo, hi, 64)
            vals = f(grid)
            for i in range(len(grid) - 1):
                if vals[i] * vals[i + 1] < 0:
                    roots.append(brentq(f, grid[i], grid[i + 1], xtol=1e-13))
        k += 1
    return np.array(roots[:n_terms])


def _kl_factor(coord, eta, n_terms=6, sigma=1.0):
    """Per-axis KL mode values: [n_terms, *coord.shape]."""
    omega = calculate_omega_based_on_eta(eta)[:n_terms]
    lam = 2.0 * eta * sigma / (1.0 + (eta * omega) ** 2)
    w = omega.reshape((-1,) + (1,) * np.ndim(coord))
    modes = (eta * w * np.cos(w * coord) + np.sin(w * coord))
    return np.sqrt(lam).reshape(w.shape) * modes


def construct_KL_sum_2D(x, y, rand_tensor_list, eta_x=0.5, eta_y=0.5):
    """6-term separable KL sum (reference gen_input_calc.py:74-91)."""
    fx = _kl_factor(x, eta_x)
    fy = _kl_factor(y, eta_y)
    out = np.zeros(np.broadcast(x, y).shape)
    for i in range(6):
        out = out + rand_tensor_list[i] * fx[i] * fy[i]
    return out


def construct_KL_sum_3D(x, y, z, rand_tensor_list, eta_x=0.5, eta_y=0.5,
                        eta_z=0.5):
    """3D separable KL sum (reference gen_input_calc.py:93-114)."""
    fx = _kl_factor(x, eta_x)
    fy = _kl_factor(y, eta_y)
    fz = _kl_factor(z, eta_z)
    out = np.zeros(np.broadcast(x, y, z).shape)
    for i in range(6):
        out = out + rand_tensor_list[i] * fx[i] * fy[i] * fz[i]
    return out


def grid2D(nx, ny):
    x = np.linspace(0, 1, nx)
    y = np.linspace(0, 1, ny)
    return np.meshgrid(x, y)


def grid3D(nx, ny, nz):
    x = np.linspace(0, 1, nx)
    y = np.linspace(0, 1, ny)
    z = np.linspace(0, 1, nz)
    return np.meshgrid(x, y, z)


def generate_diffusivity_tensor(coeff, output_size=64, nsd=2, n_sum_nu=6):
    """nu = exp(KL_sum(coeff)) positive diffusivity field
    (reference gen_input_calc.py:132-181)."""
    n = output_size
    coeffs = list(np.asarray(coeff).tolist())
    while len(coeffs) < 6:
        coeffs.append(0.0)
    coeffs = [c if i < n_sum_nu else 0.0 for i, c in enumerate(coeffs[:6])]
    if nsd == 2:
        xv, yv = grid2D(n, n)
        kl = construct_KL_sum_2D(xv[None], yv[None], coeffs)
    else:
        xv, yv, zv = grid3D(n, n, n)
        kl = construct_KL_sum_3D(xv[None], yv[None], zv[None], coeffs)
    return np.exp(kl)


def sobol_coefficients(n_samples, dim=6, scale=0.5, seed=0):
    """Quasi-random (Sobol) KL coefficient samples — generates what the
    reference ships as precomputed assets (examples/poisson/parametric/
    sobol_4d.npy / sobol_6d.npy, consumed by KLSumStochastic and the UQ
    query pipeline). Values are mapped from [0,1]^dim to
    [-scale, scale]^dim."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=dim, scramble=True, seed=seed)
    u = eng.random(n_samples)
    return ((u - 0.5) * 2.0 * scale).astype(np.float32)
