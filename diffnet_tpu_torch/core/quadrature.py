"""Gauss quadrature rules and tensor-product Lagrange basis tables.

A verbatim copy of ``diffnet_tpu/core/quadrature.py`` (numpy only): the
port must not import the JAX package, and its tables must equal the JAX
package's bit for bit (pinned by tests/test_torch_fem.py).

Redesign of the reference conv-quadrature setup
(reference: DiffNet/DiffNetFEM.py:21-141,178-284,382-481). Instead of storing
one small conv kernel per Gauss point (``N_gp[i]`` of shape ``[1,1,nbf,nbf]``),
we precompute *fused* dense tables ``[ngp_total, nbf_total]`` per derivative
quantity. Evaluation of a field at every Gauss point of every element then
becomes a single matmul against the (concatenated) tables — one MXU
contraction instead of ``ngp * n_quantities`` separate convolutions.

All table construction happens host-side in float64 numpy at setup time; the
tables are closed over by jit as constants and cast to the compute dtype.

Conventions (match the reference):
  * 2D fields are indexed ``[..., y, x]`` (numpy meshgrid 'xy': row = y).
  * 3D fields are indexed ``[..., z, y, x]`` (reference CuboidMesh.meshgrid_3d
    ordering, cuboid_mesh.py:8-25).
  * Linear Gauss-point id   IGP = ngp_1d*jgp + igp            (2D)
                            IGP = ngp_1d^2*kgp + ngp_1d*jgp + igp  (3D)
  * Linear basis-fn id      IBF = nbf_1d*jbf + ibf            (2D)
                            IBF = nbf_1d^2*kbf + nbf_1d*jbf + ibf  (3D)
    with i ↔ x, j ↔ y, k ↔ z (reference DiffNetFEM.py:205-215,419-435).

Known reference bugs intentionally FIXED here (validated by tests):
  * 3D ``d2N_z_gp`` table was a copy of ``d2N_x_gp`` (DiffNetFEM.py:450).
  * 3D second-derivative tables were written with transposed bf indices
    ``[ibf,jbf,kbf]`` (DiffNetFEM.py:430-435).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np

__all__ = [
    "gauss_quadrature_1d",
    "lagrange_basis_1d",
    "FEMBasis",
    "make_basis",
    "QUANTITIES_2D",
    "QUANTITIES_3D",
]


def gauss_quadrature_1d(ngp_1d: int) -> tuple[np.ndarray, np.ndarray]:
    """1D Gauss-Legendre points/weights on [-1, 1].

    Mirrors the reference tables (DiffNetFEM.py:128-141) but at full float64
    precision (the reference truncates the 3- and 4-point rules to 9 digits).
    """
    if not 1 <= ngp_1d <= 8:
        raise ValueError(f"ngp_1d must be in [1, 8], got {ngp_1d}")
    # numpy's Gauss-Legendre is exact to machine precision for small n.
    x, w = np.polynomial.legendre.leggauss(ngp_1d)
    return x.astype(np.float64), w.astype(np.float64)


def lagrange_basis_1d(deg: int) -> tuple[Callable, Callable, Callable]:
    """Return (N, dN, d2N) callables for the 1D Lagrange basis of degree `deg`.

    Each maps a scalar/array xi in [-1,1] -> array of shape (deg+1,) + xi.shape.
    Nodes are equispaced on [-1, 1] (matches reference deg 1/2/3 formulas,
    DiffNetFEM.py:54-126); valid for any degree.
    """
    nodes = np.linspace(-1.0, 1.0, deg + 1)
    # Build polynomial coefficient representation of each Lagrange cardinal fn.
    polys = []
    for i in range(deg + 1):
        p = np.poly1d([1.0])
        for j in range(deg + 1):
            if j != i:
                p *= np.poly1d([1.0, -nodes[j]]) / (nodes[i] - nodes[j])
        polys.append(p)

    def N(xi):
        xi = np.asarray(xi, dtype=np.float64)
        return np.stack([p(xi) for p in polys])

    def dN(xi):
        xi = np.asarray(xi, dtype=np.float64)
        return np.stack([p.deriv(1)(xi) for p in polys])

    def d2N(xi):
        xi = np.asarray(xi, dtype=np.float64)
        return np.stack([p.deriv(2)(xi) for p in polys])

    return N, dN, d2N


# Ordered derivative-quantity names; used as keys into FEMBasis.tables.
QUANTITIES_2D = ("N", "dx", "dy", "d2x", "d2y", "d2xy")
QUANTITIES_3D = ("N", "dx", "dy", "dz", "d2x", "d2y", "d2z", "d2xy", "d2yz", "d2zx")


@dataclasses.dataclass(frozen=True)
class FEMBasis:
    """Precomputed tensor-product basis tables for a uniform grid.

    Attributes
    ----------
    nsd : spatial dimension (1, 2, or 3)
    deg : polynomial degree of the 1D Lagrange basis
    ngp_1d : 1D Gauss points per element
    h : tuple of element spacings, x-major: (hx,), (hx, hy) or (hx, hy, hz)
    gpw : [ngp_total] tensor-product quadrature weights (reference-space)
    jac : scalar transform Jacobian prod(h_i / 2)
    tables : dict quantity -> float64 array [ngp_total, nbf_total]; physical
        derivatives (chain-rule factors 2/h baked in, as in reference
        DiffNetFEM.py:211-215).
    gp_1d : [ngp_1d] reference-space 1D Gauss coordinates
    surf_tables : dict quantity -> [ngp_1d, nbf_1d] surface (facet) tables;
        2D/3D only; quantities "N", "dx", "dy" (reference DiffNetFEM.py:244-269).
    """

    nsd: int
    deg: int
    ngp_1d: int
    h: tuple[float, ...]
    gpw: np.ndarray
    jac: float
    tables: dict[str, np.ndarray]
    gp_1d: np.ndarray
    surf_tables: dict[str, np.ndarray]

    @property
    def nbf_1d(self) -> int:
        return self.deg + 1

    @property
    def nbf_total(self) -> int:
        return self.nbf_1d**self.nsd

    @property
    def ngp_total(self) -> int:
        return self.ngp_1d**self.nsd

    @property
    def jxw(self) -> np.ndarray:
        """[ngp_total] quadrature weight x Jacobian."""
        return self.gpw * self.jac

    def fused_table(self, quantities: tuple[str, ...]) -> np.ndarray:
        """Stack per-quantity tables into one [len(q)*ngp_total, nbf_total]
        matrix so that field evaluation for all quantities is one matmul."""
        return np.concatenate([self.tables[q] for q in quantities], axis=0)


def _default_ngp(deg: int) -> int:
    # Reference policy: deg1 -> 2gp, deg2/3 -> 3gp (DiffNetFEM.py:29-34).
    return 2 if deg == 1 else 3


def make_basis(
    nsd: int,
    deg: int = 1,
    h: float | tuple[float, ...] = 1.0,
    ngp_1d: int | None = None,
) -> FEMBasis:
    """Build the fused basis tables for dimension `nsd` and degree `deg`.

    `h` is the element spacing (scalar applied to all axes, or per-axis tuple
    ordered (hx, hy[, hz]) ).
    """
    if nsd not in (1, 2, 3):
        raise ValueError(f"nsd must be 1, 2, or 3, got {nsd}")
    if ngp_1d is None:
        ngp_1d = _default_ngp(deg)
    elif ngp_1d < _default_ngp(deg):
        # an explicit ngp_1d is honored as-is (reduced integration is a
        # valid request — mass lumping, stabilized forms); it used to be
        # silently clamped up to the degree default. Warn because the
        # under-integrated stiffness is rank-deficient (hourglass modes)
        # for resmin/energy losses (ADVICE r2).
        import warnings
        warnings.warn(
            f"ngp_1d={ngp_1d} under-integrates deg={deg} (default "
            f"{_default_ngp(deg)}): the stiffness operator is singular "
            "(hourglass modes); intended only for reduced-integration "
            "terms, not full resmin/energy losses", stacklevel=2)

    if np.isscalar(h):
        h = (float(h),) * nsd
    h = tuple(float(v) for v in h)
    if len(h) != nsd:
        raise ValueError(f"h must have {nsd} entries, got {h}")

    gpx, gpw_1d = gauss_quadrature_1d(ngp_1d)
    Nf, dNf, d2Nf = lagrange_basis_1d(deg)
    nbf_1d = deg + 1

    # Per-axis 1D tables evaluated at all gauss points: [ngp_1d, nbf_1d]
    N1 = Nf(gpx).T          # N1[g, b]
    dN1 = dNf(gpx).T
    d2N1 = d2Nf(gpx).T

    # chain-rule scale per axis: d/dx = (2/h) d/dxi
    s = [2.0 / hv for hv in h]

    tables: dict[str, np.ndarray] = {}
    if nsd == 1:
        gpw = gpw_1d.copy()
        tables["N"] = N1
        tables["dx"] = dN1 * s[0]
        tables["d2x"] = d2N1 * s[0] ** 2
    elif nsd == 2:
        sx, sy = s
        # out[jgp*ngp+igp, jbf*nbf+ibf] = Ay[jgp,jbf] * Ax[igp,ibf]
        def tp2(Ay, Ax):
            return np.einsum("gb,hc->ghbc", Ay, Ax).reshape(
                ngp_1d * ngp_1d, nbf_1d * nbf_1d
            )

        gpw = np.einsum("g,h->gh", gpw_1d, gpw_1d).reshape(-1)
        tables["N"] = tp2(N1, N1)
        tables["dx"] = tp2(N1, dN1) * sx
        tables["dy"] = tp2(dN1, N1) * sy
        tables["d2x"] = tp2(N1, d2N1) * sx**2
        tables["d2y"] = tp2(d2N1, N1) * sy**2
        tables["d2xy"] = tp2(dN1, dN1) * sx * sy
    else:
        sx, sy, sz = s

        # out[IGP, IBF] with IGP = kgp*ngp^2 + jgp*ngp + igp (z-major layout),
        # IBF likewise; axes ordered (z, y, x) to match field layout.
        def tp3(Az, Ay, Ax):
            return np.einsum("fb,gc,hd->fghbcd", Az, Ay, Ax).reshape(
                ngp_1d**3, nbf_1d**3
            )

        gpw = np.einsum("f,g,h->fgh", gpw_1d, gpw_1d, gpw_1d).reshape(-1)
        tables["N"] = tp3(N1, N1, N1)
        tables["dx"] = tp3(N1, N1, dN1) * sx
        tables["dy"] = tp3(N1, dN1, N1) * sy
        tables["dz"] = tp3(dN1, N1, N1) * sz
        tables["d2x"] = tp3(N1, N1, d2N1) * sx**2
        tables["d2y"] = tp3(N1, d2N1, N1) * sy**2
        tables["d2z"] = tp3(d2N1, N1, N1) * sz**2
        tables["d2xy"] = tp3(N1, dN1, dN1) * sx * sy
        tables["d2yz"] = tp3(dN1, dN1, N1) * sy * sz
        tables["d2zx"] = tp3(dN1, N1, dN1) * sz * sx

    # Surface (facet, (nsd-1)-D trace) tables: 1D tables with per-axis scale
    # (reference DiffNetFEM.py:244-269 stores N, dN*2/hx, dN*2/hy).
    surf_tables: dict[str, np.ndarray] = {}
    if nsd >= 2:
        surf_tables["N"] = N1.copy()
        surf_tables["dx"] = dN1 * s[0]
        surf_tables["dy"] = dN1 * s[1]
        if nsd == 3:
            surf_tables["dz"] = dN1 * s[2]

    jac = float(np.prod([hv / 2.0 for hv in h]))
    return FEMBasis(
        nsd=nsd,
        deg=deg,
        ngp_1d=ngp_1d,
        h=h,
        gpw=gpw,
        jac=jac,
        tables=tables,
        gp_1d=gpx,
        surf_tables=surf_tables,
    )


@lru_cache(maxsize=64)
def cached_basis(nsd: int, deg: int, h: tuple[float, ...], ngp_1d: int | None = None):
    """Memoized `make_basis` for hashable args (h must be a tuple)."""
    return make_basis(nsd, deg, h, ngp_1d)
