"""Interpolation of nodal grid fields at arbitrary points, differentiable
in the field and in the points (port of ``diffnet_tpu/core/interp.py``).

Each point's element is ``floor(p / h)`` (in the points' float32), clipped
to the grid; its ``(deg + 1)^nsd`` nodal patch is gathered by advanced
indexing and contracted with the tensor-product Lagrange basis (and its
derivatives) at the point's local coordinates. Value and gradient come out
of one pass, for any basis degree.

Convention: fields are ``[B, (nz,) ny, nx]``; points ``[B, Np, nsd]`` in
physical coordinates (x, y[, z]) on a grid spanning ``[0, L]`` per axis
with element sizes ``h``. Points outside the grid extrapolate from the
nearest element.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["grid_interp_2d", "grid_interp_3d"]


def _poly_coeffs(deg: int):
    """Coefficients of the 1D Lagrange basis N and its derivative dN on
    ``deg + 1`` equispaced nodes of [-1, 1], highest power first:
    ``[nbf_1d, deg + 1]`` each (float64 numpy)."""
    nodes = np.linspace(-1.0, 1.0, deg + 1)
    N, dN = [], []
    for i in range(deg + 1):
        p = np.poly1d([1.0])
        for j in range(deg + 1):
            if j != i:
                p *= np.poly1d([1.0, -nodes[j]]) / (nodes[i] - nodes[j])
        N.append(np.pad(p.coeffs, (deg + 1 - len(p.coeffs), 0)))
        d = p.deriv(1)
        dN.append(np.pad(d.coeffs, (deg + 1 - len(d.coeffs), 0)))
    return np.stack(N), np.stack(dN)


def _check_grid(shape, deg: int) -> None:
    for name, n_ in zip("xyz", reversed(shape)):
        if (n_ - 1) % deg:
            raise ValueError(
                f"grid axis {name} has {n_} nodes, incompatible with "
                f"deg={deg}: need (n-1) % deg == 0")


def _locate(points, u, hs, nels):
    """Per axis: the clipped element index and the local coordinate in
    [-1, 1]."""
    idx, loc = [], []
    for ax, (h, ne) in enumerate(zip(hs, nels)):
        p = points[..., ax]
        e = torch.floor(p / h).long().clamp(0, ne - 1)
        idx.append(e)
        loc.append((p - e.to(u.dtype) * h) * 2.0 / h - 1.0)
    return idx, loc


def _polyval(coeffs: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of each basis polynomial at x: ``[..., nbf]``."""
    c = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    out = torch.zeros(x.shape + (c.shape[0],), dtype=x.dtype,
                      device=x.device)
    for k in range(c.shape[1]):
        out = out * x[..., None] + c[:, k]
    return out


def _basis(deg, loc, hs, dtype):
    Nc, dNc = _poly_coeffs(deg)
    N = [_polyval(Nc, x.to(dtype)) for x in loc]
    dN = [_polyval(dNc, x.to(dtype)) * (2.0 / h) for x, h in zip(loc, hs)]
    return N, dN


def grid_interp_2d(u: torch.Tensor, points: torch.Tensor,
                   h: tuple[float, float], deg: int = 1):
    """FEM interpolation (bilinear at deg 1) of ``u [B, ny, nx]`` at
    ``points [B, Np, 2]`` (x, y); ``h = (hx, hy)``. Returns ``(vals [B,
    Np], grads [B, Np, 2])`` with grads (du/dx, du/dy)."""
    ny, nx = u.shape[-2:]
    _check_grid((ny, nx), deg)
    nbf = deg + 1
    (ex, ey), loc = _locate(points, u, h, ((nx - 1) // deg,
                                           (ny - 1) // deg))
    (Nx, Ny), (dNx, dNy) = _basis(deg, loc, h, u.dtype)
    r = torch.arange(nbf, device=u.device)
    b = torch.arange(u.shape[0], device=u.device)[:, None, None, None]
    rows = (ey[..., None] * deg + r)[..., :, None]
    cols = (ex[..., None] * deg + r)[..., None, :]
    patches = u[b, rows, cols]                     # [B, Np, nbf_y, nbf_x]

    def contract(fy, fx):
        return torch.sum(patches * (fy[..., :, None] * fx[..., None, :]),
                         dim=(-2, -1))

    vals = contract(Ny, Nx)
    return vals, torch.stack([contract(Ny, dNx), contract(dNy, Nx)], dim=-1)


def grid_interp_3d(u: torch.Tensor, points: torch.Tensor,
                   h: tuple[float, float, float], deg: int = 1):
    """The 3D counterpart of :func:`grid_interp_2d`: ``u [B, nz, ny, nx]``
    at ``points [B, Np, 3]`` (x, y, z); ``h = (hx, hy, hz)``. Returns
    ``(vals [B, Np], grads [B, Np, 3])``."""
    nz, ny, nx = u.shape[-3:]
    _check_grid((nz, ny, nx), deg)
    nbf = deg + 1
    (ex, ey, ez), loc = _locate(points, u, h, ((nx - 1) // deg,
                                               (ny - 1) // deg,
                                               (nz - 1) // deg))
    (Nx, Ny, Nz), (dNx, dNy, dNz) = _basis(deg, loc, h, u.dtype)
    r = torch.arange(nbf, device=u.device)
    b = torch.arange(u.shape[0], device=u.device)[:, None, None, None, None]
    zi = (ez[..., None] * deg + r)[..., :, None, None]
    yi = (ey[..., None] * deg + r)[..., None, :, None]
    xi = (ex[..., None] * deg + r)[..., None, None, :]
    patches = u[b, zi, yi, xi]                     # [B, Np, nbf, nbf, nbf]

    def contract(fz, fy, fx):
        w = (fz[..., :, None, None] * fy[..., None, :, None]
             * fx[..., None, None, :])
        return torch.sum(patches * w, dim=(-3, -2, -1))

    vals = contract(Nz, Ny, Nx)
    grads = torch.stack([contract(Nz, Ny, dNx), contract(Nz, dNy, Nx),
                         contract(dNz, Ny, Nx)], dim=-1)
    return vals, grads
