"""The FSDT plate, immersed Poisson and SIMP topology-optimisation cases
that the PyTorch port's slice M (chip_smoke.py) and the JAX package's
reference run (scripts/torch_port_reference_topopt.py) both build: their
sizes and budgets, the topology problem, the direct solves of the discrete
systems and the scorers.

numpy and scipy only (no JAX, no torch), so that both sides import this one
copy; each side passes its own residual function to the direct solve.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

LBFGS_ITERS = 10
# M1: examples/more_physics.py fsdt at ElasticFSDTDataset's own grid
FSDT_GRID, FSDT_EPOCHS = 64, 100
# M2: the immersed single instances at their default grid, Poisson2D's
# energy; the budget where JAX's loss has settled (see the reference
# script's docstring)
IM_CASES = ("RectangleIM", "RectangleIMBack", "CircleIMBack", "LShaped")
IM_GRID, IM_EPOCHS = 64, 50
IM_START_SCALES = (0.0, 1e-7, 1e-6, 1e-5)
# M3: tests/test_physics_misc.py::test_topopt_demonstrated_design, which is
# also examples/more_physics.py topopt's default grid
TOPOPT_GRID, TOPOPT_OUTER, TOPOPT_VF = 32, 80, 0.4

# the figures the reference run prints, one key each
FIGURES = ("fsdt", "immersed", "topopt")


def im_start(n: int, scale: float) -> np.ndarray:
    """An immersed fit's start: zeros, or a seeded normal field of that
    scale (rounding-level starts, over which a figure on float32's floor
    spreads)."""
    return scale * np.random.default_rng(0).standard_normal((n, n))


def topopt_problem(n: int = TOPOPT_GRID):
    """The JAX test's problem: a heat sink on the first row (channel 1),
    unit forcing. Returns (inputs [n, n, 4], forcing [n, n, 1])."""
    x = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(x, x)
    bc2 = np.zeros((n, n))
    bc2[0, :] = 1
    inputs = np.stack([np.zeros((n, n)), bc2, xx, yy],
                      -1).astype(np.float32)
    return inputs, np.ones((n, n, 1), np.float32)


def topopt_figures(rho: np.ndarray, hist: np.ndarray) -> dict:
    """The JAX test's five criteria on a projected design and its
    compliance history, each with its figure."""
    hist = np.asarray(hist, np.float64)
    post = hist[10:]
    figs = {"volume_fraction": float(rho.mean()),
            "compliance_first": float(hist[0]),
            "compliance_last": float(hist[-1]),
            "post10_max_over_min": float(post.max() / post.min()),
            "rho_std": float(rho.std()),
            "solid_share": float(np.mean(rho > 0.5)),
            "void_share": float(np.mean(rho < 0.1))}
    figs["criteria"] = {k: bool(v) for k, v in {
        "vf_within_0.008": abs(figs["volume_fraction"] - TOPOPT_VF) < 0.008,
        "compliance_halved": hist[-1] < 0.5 * hist[0],
        "no_regression_5pct": post.max() < 1.05 * post.min() + 1e-9,
        "two_phase_std": figs["rho_std"] > 0.15,
        "phase_shares": (figs["solid_share"] > 0.2
                         and figs["void_share"] > 0.1)}.items()}
    return figs


def coloured_jacobian(resid, n_fields: int, shape) -> tuple:
    """The sparse Jacobian A and offset b of an affine residual
    ``R(z) = A z + b`` of `n_fields` nodal fields on a deg-1 grid, from
    ``9 * n_fields`` probes: a node couples only to its 3x3 neighbourhood,
    so the nodes of one colour (i % 3, j % 3) of one field never share a
    residual row. `resid` maps float64 ``[n_fields, ny, nx]`` to the same
    shape. Returns (A as CSR [N, N], b [N]) with N = n_fields * ny * nx."""
    ny, nx = shape
    size = ny * nx
    b = np.asarray(resid(np.zeros((n_fields, ny, nx))), np.float64)
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    rows, cols, vals = [], [], []
    for k in range(n_fields):
        for cj in range(3):
            for ci in range(3):
                e = np.zeros((n_fields, ny, nx))
                sel = (jj % 3 == cj) & (ii % 3 == ci)
                e[k][sel] = 1.0
                d = np.asarray(resid(e), np.float64) - b
                nj, ni = jj[sel], ii[sel]
                for dj in (-1, 0, 1):
                    for di in (-1, 0, 1):
                        rj, ri = nj + dj, ni + di
                        ok = (rj >= 0) & (rj < ny) & (ri >= 0) & (ri < nx)
                        for f in range(n_fields):
                            v = d[f, rj[ok], ri[ok]]
                            nz = v != 0
                            rows.append(f * size + (rj[ok] * nx + ri[ok])[nz])
                            cols.append(k * size + (nj[ok] * nx + ni[ok])[nz])
                            vals.append(v[nz])
    N = n_fields * size
    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(N, N))
    return A, b.reshape(-1)


def direct_solve(resid, n_fields: int, shape) -> tuple:
    """The float64 solve of ``R(z) = 0`` on the free rows (those the
    residual does not zero: not Dirichlet, and not outside every object).
    Returns (z [n_fields, ny, nx], free mask [n_fields, ny, nx])."""
    A, b = coloured_jacobian(resid, n_fields, shape)
    free = np.asarray(abs(A).sum(axis=1)).ravel() > 0
    z = np.zeros(b.shape)
    z[free] = spla.spsolve(A[free][:, free].tocsc(), -b[free])
    return z.reshape((n_fields,) + tuple(shape)), free.reshape(
        (n_fields,) + tuple(shape))


def rel_l2_free(u: np.ndarray, ref: np.ndarray, free: np.ndarray) -> float:
    """Relative L2 error of `u` against `ref` on the free nodes."""
    d = (np.asarray(u, np.float64) - ref)[free]
    return float(np.linalg.norm(d) / np.linalg.norm(ref[free]))
