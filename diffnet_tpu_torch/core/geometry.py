"""Immersed-boundary geometry: generalized winding numbers and point-cloud
synthesis (port of ``diffnet_tpu/core/geometry.py``).

The generalized winding number of query q against an oriented point cloud
{p_i, n_i, a_i} is  w(q) = sum_i a_i (p_i - q)·n_i / (2 pi |p_i - q|^2)
in 2D and  sum_i a_i (p_i - q)·n_i / (4 pi |p_i - q|^3)  in 3D: ~1 inside,
~0 outside, 1/2 on the curve. The winding functions take torch tensors, run
on the tensors' device, and stay differentiable in the cloud; they loop
over chunks of queries so the ``[B, chunk, Np]`` pairwise tensors stay
bounded (4,096 queries a chunk in 2D, 2,048 in 3D, as in the JAX package).
The cloud samplers are host numpy, the JAX package's own code.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["winding_number_2d", "winding_number_3d", "winding_grid",
           "occupancy_from_cloud", "occupancy_from_cloud_3d", "meshgrid_3d",
           "sample_ellipse_cloud", "sample_polygon_cloud",
           "sample_sphere_cloud", "cloud_from_voxels"]


def _winding(points, normals, areas, queries, chunk, kernel):
    """``sum_i areas_i kernel(d_i · n_i, |d_i|^2)`` with d = p - q, per
    chunk of queries; points, normals [B, Np, D], queries [Nq, D] ->
    [B, Nq]."""
    out = []
    for qc in torch.split(queries, chunk):
        # one [B, chunk, Np] plane per coordinate: no size-D trailing axis
        d = [points[:, None, :, k] - qc[None, :, k, None]
             for k in range(points.shape[-1])]
        dot = sum(dk * normals[:, None, :, k] for k, dk in enumerate(d))
        r2 = sum(dk * dk for dk in d)
        out.append(torch.sum(areas[:, None, :] * kernel(dot, r2), dim=-1))
    return torch.cat(out, dim=1)


def winding_number_2d(points: torch.Tensor, normals: torch.Tensor,
                      areas: torch.Tensor, queries: torch.Tensor,
                      chunk: int = 4096, eps: float = 1e-8) -> torch.Tensor:
    """Generalized winding number of `queries` w.r.t. an oriented 2D cloud.

    points, normals: [B, Np, 2]; areas: [B, Np] (arc-length weights);
    queries: [Nq, 2] (shared across the batch) -> [B, Nq]."""
    return _winding(points, normals, areas, queries, chunk,
                    lambda dot, r2: dot / (2 * math.pi * (r2 + eps)))


def winding_number_3d(points: torch.Tensor, normals: torch.Tensor,
                      areas: torch.Tensor, queries: torch.Tensor,
                      chunk: int = 2048, eps: float = 1e-8) -> torch.Tensor:
    """3D generalized winding number (solid angle / 4 pi).

    points, normals: [B, Np, 3]; areas: [B, Np]; queries: [Nq, 3] -> [B, Nq].
    """
    return _winding(points, normals, areas, queries, chunk,
                    lambda dot, r2: dot / (4 * math.pi
                                           * torch.sqrt(r2 + eps) ** 3))


def _linspace(length, n, like: torch.Tensor) -> torch.Tensor:
    """n node coordinates from 0 to `length`: ``i * (1 / (n - 1))`` in
    float32, the last pinned to 1, times `length`. At unit length these are
    the JAX package's nodes on a CPU, bit for bit (``torch.linspace``
    lands an ulp away at some; next to a cloud point, where w is steep,
    an ulp moves w by ~1e-4)."""
    t = torch.arange(n, dtype=like.dtype, device=like.device) \
        * (1.0 / max(n - 1, 1))
    t[-1] = 1.0 if n > 1 else 0.0
    return length * t


def winding_grid(points, normals, areas, grid_shape, lengths=(1.0, 1.0),
                 chunk: int = 4096) -> torch.Tensor:
    """The raw (unthresholded) winding number on the node grid,
    differentiable in the cloud; [B, ny, nx]."""
    ny, nx = grid_shape
    yy, xx = torch.meshgrid(_linspace(lengths[1], ny, points),
                            _linspace(lengths[0], nx, points), indexing="ij")
    q = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    w = winding_number_2d(points, normals, areas, q, chunk=chunk)
    return w.reshape(points.shape[0], ny, nx)


def occupancy_from_cloud(points, normals, areas, grid_shape,
                         lengths=(1.0, 1.0), threshold: float = 0.5,
                         chunk: int = 4096) -> torch.Tensor:
    """Characteristic function chi = (w > threshold) on the node grid from
    an oriented 2D cloud (the IBN source mask); [B, ny, nx]."""
    w = winding_grid(points, normals, areas, grid_shape, lengths, chunk)
    return (w > threshold).to(points.dtype)


def occupancy_from_cloud_3d(points, normals, areas, grid_shape,
                            lengths=(1.0, 1.0, 1.0), threshold: float = 0.5,
                            chunk: int = 2048) -> torch.Tensor:
    """3D characteristic function chi on the node grid from an oriented
    cloud; [B, nz, ny, nx]."""
    nz, ny, nx = grid_shape
    zz, yy, xx = torch.meshgrid(_linspace(lengths[2], nz, points),
                                _linspace(lengths[1], ny, points),
                                _linspace(lengths[0], nx, points),
                                indexing="ij")
    q = torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], dim=-1)
    w = winding_number_3d(points, normals, areas, q, chunk=chunk)
    chi = (w > threshold).to(points.dtype)
    return chi.reshape(points.shape[0], nz, ny, nx)


def meshgrid_3d(x_1d, y_1d, z_1d):
    """(M,), (N,), (P,) -> three (P, N, M) arrays, z-major ordering."""
    zz, yy, xx = np.meshgrid(z_1d, y_1d, x_1d, indexing="ij")
    return xx, yy, zz


def sample_ellipse_cloud(n_points=120, center=(0.5, 0.5), radii=(0.25, 0.15),
                         angle=0.0, rng=None):
    """An oriented boundary cloud (points, outward normals, arc-length
    areas) of an ellipse. `rng` adds a random phase offset to the otherwise
    uniform parameter sampling (deterministic when None)."""
    t = np.linspace(0, 2 * np.pi, n_points, endpoint=False)
    if rng is not None:
        t = t + rng.uniform(0.0, 2 * np.pi / n_points)
    a, b = radii
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    pts_local = np.stack([a * np.cos(t), b * np.sin(t)], axis=-1)
    pts = pts_local @ R.T + np.asarray(center)
    # outward normal of the ellipse: grad((x/a)^2 + (y/b)^2)
    nrm_local = np.stack([np.cos(t) / a, np.sin(t) / b], axis=-1)
    nrm = nrm_local @ R.T
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    # arc-length weights: half the distance to each neighbour
    d = np.linalg.norm(np.roll(pts, -1, 0) - pts, axis=-1)
    areas = 0.5 * (d + np.roll(d, 1, 0))
    return (pts.astype(np.float32), nrm.astype(np.float32),
            areas.astype(np.float32))


def sample_sphere_cloud(n_points=2000, center=(0.5, 0.5, 0.5), radius=0.25,
                        rng=None):
    """Oriented surface cloud of a sphere (points, outward unit normals,
    per-point areas summing to 4 pi r^2): random directions with `rng`,
    else a Fibonacci sphere."""
    if rng is not None:
        v = rng.standard_normal((n_points, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    else:
        i = np.arange(n_points) + 0.5
        phi = np.arccos(1 - 2 * i / n_points)
        golden = np.pi * (1 + 5**0.5)
        theta = golden * i
        v = np.stack([np.cos(theta) * np.sin(phi),
                      np.sin(theta) * np.sin(phi), np.cos(phi)], axis=-1)
    pts = np.asarray(center) + radius * v
    areas = np.full(n_points, 4 * np.pi * radius**2 / n_points)
    return (pts.astype(np.float32), v.astype(np.float32),
            areas.astype(np.float32))


def cloud_from_voxels(vox, lengths=(1.0, 1.0, 1.0), max_points=None,
                      rng=None):
    """Oriented surface cloud from a [nz, ny, nx] binary voxel occupancy.

    Surface voxels are occupied with at least one empty 6-neighbour. Point:
    the voxel centre; normal: the negative gradient of the box-smoothed
    occupancy, unit; area: the total exposed-face area (each orientation
    with its own face area) split evenly over the points kept."""
    from scipy import ndimage

    vox = np.asarray(vox).astype(np.float32)
    nz, ny, nx = vox.shape
    pad = np.pad(vox, 1)
    neigh_min = np.minimum.reduce([
        pad[:-2, 1:-1, 1:-1], pad[2:, 1:-1, 1:-1], pad[1:-1, :-2, 1:-1],
        pad[1:-1, 2:, 1:-1], pad[1:-1, 1:-1, :-2], pad[1:-1, 1:-1, 2:]])
    occ = vox > 0.5
    empty = ~np.pad(occ, 1)
    fz = (empty[:-2, 1:-1, 1:-1] & occ).sum() + (empty[2:, 1:-1, 1:-1]
                                                 & occ).sum()
    fy = (empty[1:-1, :-2, 1:-1] & occ).sum() + (empty[1:-1, 2:, 1:-1]
                                                 & occ).sum()
    fx = (empty[1:-1, 1:-1, :-2] & occ).sum() + (empty[1:-1, 1:-1, 2:]
                                                 & occ).sum()
    surf = occ & (neigh_min < 0.5)
    iz, iy, ix = np.nonzero(surf)
    if max_points is not None and iz.size > max_points:
        sel = ((rng or np.random.default_rng(0))
               .choice(iz.size, max_points, replace=False))
        iz, iy, ix = iz[sel], iy[sel], ix[sel]
    h = (lengths[0] / nx, lengths[1] / ny, lengths[2] / nz)
    pts = np.stack([(ix + 0.5) * h[0], (iy + 0.5) * h[1],
                    (iz + 0.5) * h[2]], axis=-1)
    sm = ndimage.uniform_filter(vox, size=3, mode="constant")
    gz, gy, gx = np.gradient(sm)
    nrm = -np.stack([gx[iz, iy, ix], gy[iz, iy, ix], gz[iz, iy, ix]],
                    axis=-1)
    mag = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(mag > 1e-8, nrm / np.maximum(mag, 1e-8), 0.0)
    keep = np.linalg.norm(nrm, axis=-1) > 0.5
    pts, nrm = pts[keep], nrm[keep]
    total_area = (fx * h[1] * h[2] + fy * h[0] * h[2] + fz * h[0] * h[1])
    areas = np.full(len(pts), total_area / max(len(pts), 1), np.float32)
    return pts.astype(np.float32), nrm.astype(np.float32), areas


def sample_polygon_cloud(vertices, points_per_edge=30):
    """Oriented cloud along a CCW polygon boundary."""
    vertices = np.asarray(vertices, np.float64)
    pts, nrms, areas = [], [], []
    nv = len(vertices)
    for i in range(nv):
        p0, p1 = vertices[i], vertices[(i + 1) % nv]
        edge = p1 - p0
        L = np.linalg.norm(edge)
        tang = edge / L
        normal = np.array([tang[1], -tang[0]])  # outward for CCW
        ts = (np.arange(points_per_edge) + 0.5) / points_per_edge
        pts.append(p0 + ts[:, None] * edge)
        nrms.append(np.tile(normal, (points_per_edge, 1)))
        areas.append(np.full(points_per_edge, L / points_per_edge))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(nrms).astype(np.float32),
            np.concatenate(areas).astype(np.float32))
