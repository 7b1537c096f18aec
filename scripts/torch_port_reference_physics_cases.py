"""The single-instance physics cases that the PyTorch port's slice L
(chip_smoke.py) and the JAX package's reference run
(scripts/torch_port_reference_physics.py) both build: their sizes and
budgets, the manufactured solutions and forcings, the datasets the packages
do not ship, and the scorers.

numpy only (no JAX, no torch), so that both sides import this one copy.
"""

from __future__ import annotations

import math

import numpy as np

PI = math.pi
LBFGS_ITERS = 10
HELM_GRID, HELM_EPOCHS = 65, 100
HELM_K12, HELM_K12_TOL, HELM_K12_MAXITER = 12.0, 1e-10, 100
ADV_GRID, ADV_EPOCHS, ADV_NU = 65, 200, 0.05
ADV_GRID_COARSE = 33
ADV_START_SCALES = (0.0, 1e-7, 1e-6, 1e-5)
ADV_A = (math.cos(PI / 6), math.sin(PI / 6))
SKEW_GRID, SKEW_EPOCHS, SKEW_NU = 64, 80, 1e-4
HEAT_GRID, HEAT_EPOCHS = 33, 150
AC_GRID = 33
AC_CONST = {"A": 16.0, "Cn": 0.1, "D": 1.0, "k": 2.0}
AC_LINEAR = {"method": "gmres", "tol": 1e-8, "maxiter": 400, "restart": 30}
AC_NEWTON = {"newton_iters": 5, "gmres_iters": 4, "restart": 25,
             "tol": 1e-9}
BURGERS_GRID, BURGERS_EPOCHS = 33, 100
TWODOF_GRID, TWODOF_EPOCHS = 33, 100
FDM_GRID, FDM_EPOCHS = 64, 150
EIK_GRID, AIRFOIL_POINTS, AIRFOIL_EPOCHS = 64, 200, 200
EIK_WEIGHTS = {"sdf_weight": 100.0, "normals_weight": 10.0}
GN = {"newton_iters": 40, "cg_iters": 100, "lm": 1e-4}
CIRCLE_POINTS, SPHERE_GRID, SPHERE_POINTS = 100, 32, 2000
EIK_FDM_EPOCHS, EIK_FDM_POINTS = 50, 150

# the figures the reference run prints, one key each
FIGURES = ("helmholtz_mms_rel_l2", "helmholtz_k12_rel_l2",
           "advdiff_mms_rel_l2", "advdiff_mms_rel_l2_starts",
           "advdiff_mms_coarse_rel_l2", "skew_min", "skew_max",
           "skew_centre", "heat_rel_l2", "allencahn_rel_l2",
           "allencahn_newton_iters", "allencahn_residual_history",
           "burgers_rel_l2", "twodof_rel_l2", "fdm_max_interior_err",
           "airfoil", "circle_gn", "sphere_gn", "eikonal_fdm")


def advdiff_exact(x, y):
    return np.sin(PI * x) * np.sin(PI * y)


def advdiff_forcing(x, y):
    ax, ay = ADV_A
    return (ax * PI * np.cos(PI * x) * np.sin(PI * y)
            + ay * PI * np.sin(PI * x) * np.cos(PI * y)
            + ADV_NU * 2 * PI**2 * np.sin(PI * x) * np.sin(PI * y))


def advdiff_start(n, scale):
    """The MMS start: zeros, or a seeded normal field of that scale (the
    starts that show the float32 floor's spread at 65^2)."""
    return scale * np.random.default_rng(0).standard_normal((n, n))


def heat_exact_forcing(ds):
    decay, nu = ds.decay_rt, ds.diffusivity

    def exact(x, y):
        return np.sin(PI * x) * np.exp(-decay * y)

    def forcing(x, y):
        return np.sin(PI * x) * np.exp(-decay * y) * (nu * PI**2 - decay)

    return exact, forcing


def ac_exact(x, y):
    return np.sin(PI * x) * np.sin(PI * y)


def ac_forcing(x, y):
    A, Cn, D, k = (AC_CONST[c] for c in ("A", "Cn", "D", "k"))
    u = np.sin(PI * x) * np.sin(PI * y)
    u_t = PI * np.sin(PI * x) * np.cos(PI * y)
    G = 2.0 * D * A * (u - 3 * u**2 + 2 * u**3) - D * k
    return u_t + D * G + D * Cn**2 * 2 * PI**2 * u


def ac_linforcing(x, y):
    Cn, D, k = AC_CONST["Cn"], AC_CONST["D"], AC_CONST["k"]
    u = np.sin(PI * x) * np.sin(PI * y)
    u_t = PI * np.sin(PI * x) * np.cos(PI * y)
    return u_t - D * D * k + D * Cn**2 * 2 * PI**2 * u


def ac_frame(ds, n):
    """The MMS Dirichlet frame: the initial row (bc1), the sides and the
    top row (bc2), u0 = 0."""
    ds.n_samples = 1
    ds.bc2 = np.zeros((n, n))
    ds.bc2[:, [0, -1]] = 1.0
    ds.bc2[-1, :] = 1.0
    ds.u0 = np.zeros((n, n))
    return ds


class BurgersMMS:
    """u = sin(pi x) exp(-t) on the unit square, the y axis time: the
    initial row from bc1_val, u = 0 on the x walls (scripts/
    convergence_study.py's dataset)."""

    n_samples = 1

    def __init__(self, n):
        x = np.linspace(0, 1, n)
        self.xx, self.yy = np.meshgrid(x, x)
        bc1 = np.full((n, n), -10.0)
        bc1_val = np.zeros((n, n))
        bc1[0, :] = 1.0
        bc1_val[0, :] = np.sin(PI * x)
        bc2 = np.full((n, n), -10.0)
        bc2[:, 0] = 1.0
        bc2[:, -1] = 1.0
        self.inputs = np.stack([self.xx, bc1, bc2, bc1_val],
                               -1).astype(np.float32)
        self.forcing = np.zeros((n, n, 1), np.float32)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def burgers_exact(x, y):
    return np.sin(PI * x) * np.exp(-y)


def burgers_forcing(x, y):
    return (-np.sin(PI * x) * np.exp(-y)
            + np.sin(PI * x) * np.exp(-y) * PI * np.cos(PI * x) * np.exp(-y))


def airfoil_control_polygon():
    t = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    return np.stack([0.5 + 0.3 * np.cos(t),
                     0.5 + 0.12 * np.sin(t) * (1.2 - np.cos(t))], -1)


def cloud_of(pts, nrm, area):
    return np.concatenate([pts, nrm, area[:, None]], -1).astype(np.float32)


def sdf_error(u, radius=0.25, center=0.5):
    """Mean |u - (r - radius)| over the nodes with r < 0.45 (the corners
    left out), on a unit grid of u's shape."""
    axes = [np.linspace(0, 1, s) for s in u.shape]
    grids = np.meshgrid(*axes, indexing="ij")
    rr = np.sqrt(sum((g - center) ** 2 for g in grids))
    return float(np.abs(u - (rr - radius))[rr < 0.45].mean())


def airfoil_figures(u, pts, chi) -> dict:
    """Mean |u| on the cloud against h, and the sign structure: the median
    inside (chi > 0.5) and two corner values."""
    n = u.shape[0]
    h = 1.0 / (n - 1)
    # bilinear values at the cloud points (the interpolation of
    # core/interp.py at deg 1, in numpy)
    e = np.clip(np.floor(pts / h).astype(int), 0, n - 2)
    loc = pts / h - e
    ix, iy = e[:, 0], e[:, 1]
    sx, sy = loc[:, 0], loc[:, 1]
    vals = ((1 - sx) * (1 - sy) * u[iy, ix] + sx * (1 - sy) * u[iy, ix + 1]
            + (1 - sx) * sy * u[iy + 1, ix] + sx * sy * u[iy + 1, ix + 1])
    inside = chi > 0.5
    return {"mean_abs_u_cloud": float(np.abs(vals).mean()), "h": h,
            "median_inside": float(np.median(u[inside])),
            "corner_00": float(u[2, 2]), "corner_11": float(u[-3, -3]),
            "inside_nodes": int(inside.sum())}
