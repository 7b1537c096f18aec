"""Finite-difference stencil derivatives on uniform grids (port of
``diffnet_tpu/core/fdm.py``).

Stencils are applied as separable shifted-slice contractions: a k-tap
stencil along an axis is k slices of the field, scaled and summed; the
smoothing taps of the other axes are applied the same way. Boundary
corrections replace the 1-2 affected boundary columns.

Two evaluation modes:
  * ``mode="interior"``: the valid (unpadded) stencil; the output shrinks
    by the stencil radius on each side of every spatial axis;
  * ``mode="full"``: edge-replicated padding, then a one-sided boundary
    correction; the output has the field's shape.

As in the JAX package, the ``fs`` learned-filter taps are normalised to a
correct derivative, ``laplacian`` is dxx + dyy (+ dzz), and the 5-point
boundary constants are solved to be exact on monomials (not DiffNet's
hardcoded ones).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Literal, Sequence

import numpy as np
import torch

__all__ = ["FDMStencils", "make_fdm"]

KType = Literal["fdm", "sobel", "fs"]


def _stencil_taps(ktype: KType, num_pt: int, n: int):
    """1D ``(stencil, weights, d2_stencil, d2_weights)`` taps, the stencil
    scaled by ``(n - 1)`` (unit-length axis of n nodes)."""
    if ktype == "fs":
        # the learned 5-tap derivative (k1) and smoothing (k2) taps, an
        # outer product; k1 normalised so a unit-slope field gives ~1
        k1 = np.array([0.104550, 0.292315, 0.0, -0.292315, -0.104550])
        k2 = np.array([0.25, 0.5, 1.0, 0.5, 0.25])
        stencil = -k1 * (n - 1)
        d2_stencil = ((n - 1) ** 2) * np.array([1.0, -2.0, 1.0])
        d2_weights = np.ones(3)
        return (stencil, k2 / k2.sum(), d2_stencil,
                d2_weights / d2_weights.sum())
    if num_pt == 3:
        stencil = np.array([-1.0, 0.0, 1.0]) * ((n - 1) / 2.0)
        weights = {"fdm": np.array([1.0, 1.0, 1.0]),
                   "sobel": np.array([1.0, 2.0, 1.0])}[ktype]
    elif num_pt == 5:
        stencil = np.array([1.0, -8.0, 0.0, 8.0, -1.0]) * ((n - 1) / 12.0)
        weights = {"fdm": np.ones(5),
                   "sobel": np.array([1.0, 4.0, 6.0, 4.0, 1.0])}[ktype]
    else:
        raise ValueError(f"num_pt must be 3 or 5, got {num_pt}")
    # the second derivative is 3-point only
    d2_stencil = ((n - 1) ** 2) * np.array([1.0, -2.0, 1.0])
    d2_weights = np.array([1.0, 1.0, 1.0])
    return (stencil, weights / weights.sum(), d2_stencil,
            d2_weights / d2_weights.sum())


def _apply_taps(u: torch.Tensor, taps: np.ndarray, axis: int
                ) -> torch.Tensor:
    """Valid 1D correlation along `axis`: k shifted slices scaled and
    summed (zero taps skipped)."""
    k = len(taps)
    length = u.shape[axis] - (k - 1)
    out = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        piece = u.narrow(axis, i, length) * float(t)
        out = piece if out is None else out + piece
    if out is None:   # all-zero taps
        out = torch.zeros_like(u.narrow(axis, 0, length))
    return out


def _replicate_pad(u: torch.Tensor, pad: int, axes: Sequence[int]
                   ) -> torch.Tensor:
    """Pad `pad` nodes on each side of each of `axes` with the edge
    values."""
    for ax in axes:
        n = u.shape[ax]
        idx = torch.arange(-pad, n + pad, device=u.device).clamp(0, n - 1)
        u = u.index_select(ax, idx)
    return u


def _axis_index(u_ndim: int, nsd: int, axis_name: str) -> int:
    """'x' / 'y' / 'z' as a trailing-axis index of a ``[..., (z,) y, x]``
    field."""
    offset = {"x": 1, "y": 2, "z": 3}[axis_name]
    if offset > nsd:
        raise ValueError(f"axis {axis_name!r} invalid for nsd={nsd}")
    return u_ndim - offset


@lru_cache(maxsize=8)
def _d1_correction_coeffs(num_pt: int) -> np.ndarray:
    """Coefficients of the boundary columns' correction for the
    edge-padded first derivative, solved so each corrected column is exact
    on the monomials up to the stencil's interior order (x..x^2 for
    3-point, x..x^3 for 5-point). Returns ``[n_fix_cols, n_coeffs]``."""
    k = 1 if num_pt == 3 else 2      # boundary columns to fix per side
    m = 2 if num_pt == 3 else 3      # coefficients per column
    pad = (num_pt - 1) // 2
    taps = (np.array([-1.0, 0.0, 1.0]) / 2.0 if num_pt == 3
            else np.array([1.0, -8.0, 0.0, 8.0, -1.0]) / 12.0)
    x = np.arange(12, dtype=np.float64)

    def raw_d(u):
        return np.correlate(np.pad(u, pad, mode="edge"), taps, mode="valid")

    out = np.zeros((k, m))
    for col in range(k):
        A = np.zeros((m, m))
        b = np.zeros(m)
        for j, p in enumerate(range(1, m + 1)):
            A[j] = raw_d(x**p)[:m]
            b[j] = p * x[col] ** (p - 1)
        out[col] = np.linalg.solve(A, b)
    return out


def _d1_boundary_fix(d: torch.Tensor, axis: int, num_pt: int
                     ) -> torch.Tensor:
    """Replace the first and last k columns of the raw first derivative by
    the one-sided combinations of :func:`_d1_correction_coeffs`."""
    C = _d1_correction_coeffs(num_pt)
    k, m = C.shape
    L = d.shape[axis]

    def combo(col, idx):
        total = 0
        for j in range(m):
            total = total + float(C[col, j]) * d.select(axis, idx(j))
        return total.unsqueeze(axis)

    head = [combo(col, lambda j: j) for col in range(k)]
    tail = [combo(col, lambda j: L - 1 - j) for col in reversed(range(k))]
    return torch.cat(head + [d.narrow(axis, k, L - 2 * k)] + tail, dim=axis)


def _d2_boundary_fix(d: torch.Tensor, axis: int) -> torch.Tensor:
    """Copy the adjacent interior value onto each boundary column."""
    L = d.shape[axis]
    return torch.cat([d.narrow(axis, 1, 1), d.narrow(axis, 1, L - 2),
                      d.narrow(axis, L - 2, 1)], dim=axis)


@dataclasses.dataclass(frozen=True)
class FDMStencils:
    """Finite-difference derivative operators for an ``n``-node
    unit-length axis grid. Fields are ``[..., (z,) y, x]`` with any leading
    batch dims. ``ktype="fs"`` is a fixed 5-tap stencil: ``num_pt`` 3 (the
    default) becomes 5, any other value raises."""

    nsd: int
    n: int
    ktype: KType = "fdm"
    num_pt: int = 3

    def __post_init__(self):
        if self.nsd not in (2, 3):
            raise ValueError(f"nsd must be 2 or 3, got {self.nsd}")
        if self.ktype == "fs":
            if self.num_pt == 3:
                object.__setattr__(self, "num_pt", 5)
            elif self.num_pt != 5:
                raise ValueError(
                    f"ktype='fs' uses a fixed 5-tap stencil; "
                    f"num_pt={self.num_pt} is incompatible (pass num_pt=5 "
                    "or omit it)")

    def _taps(self):
        return _stencil_taps(self.ktype, self.num_pt, self.n)

    def _derivative(self, u, axis_name, mode, stencil, w, width, fix):
        ax = _axis_index(u.ndim, self.nsd, axis_name)
        sp_axes = list(range(u.ndim - self.nsd, u.ndim))
        if mode == "full":
            u = _replicate_pad(u, (width - 1) // 2, sp_axes)
        out = _apply_taps(u, stencil, ax)
        for other in sp_axes:
            if other != ax:
                out = _apply_taps(out, np.ones(width) * w, other)
        return fix(out, ax) if mode == "full" else out

    def _d1(self, u, axis_name, mode):
        stencil, w, _, _ = self._taps()
        return self._derivative(
            u, axis_name, mode, stencil, w, self.num_pt,
            lambda d, ax: _d1_boundary_fix(d, ax, self.num_pt))

    def _d2(self, u, axis_name, mode):
        _, _, d2s, d2w = self._taps()
        return self._derivative(u, axis_name, mode, d2s, d2w, 3,
                                _d2_boundary_fix)

    def dx(self, u, mode="interior"):
        return self._d1(u, "x", mode)

    def dy(self, u, mode="interior"):
        return self._d1(u, "y", mode)

    def dz(self, u, mode="interior"):
        return self._d1(u, "z", mode)

    def dxx(self, u, mode="interior"):
        return self._d2(u, "x", mode)

    def dyy(self, u, mode="interior"):
        return self._d2(u, "y", mode)

    def dzz(self, u, mode="interior"):
        return self._d2(u, "z", mode)

    def laplacian(self, u, mode="interior"):
        out = self.dxx(u, mode) + self.dyy(u, mode)
        if self.nsd == 3:
            out = out + self.dzz(u, mode)
        return out


def make_fdm(nsd: int, n: int, ktype: KType = "fdm",
             num_pt: int = 3) -> FDMStencils:
    return FDMStencils(nsd=nsd, n=n, ktype=ktype, num_pt=num_pt)
