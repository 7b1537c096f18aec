"""Geometry-derived datasets (the port's copy of the numpy code of
``diffnet_tpu/data/geometry_datasets.py``; samples equal the JAX
package's):

  * ``image_to_point_cloud`` and ``PCVox``: a binary image -> Sobel normals
    -> a boundary point cloud;
  * ``nurbs_curve`` and ``ParametricNURBS``: NURBS boundary clouds from
    randomised control polygons, the winding batches of ``IBNPoisson2D``;
  * ``synthesize_topology_3d`` and ``TopoDataset3D``: 3D topology volumes
    (npz files or synthetic bar lattices) as ``IBNPoisson3D`` batches;
  * ``Burg2DXT``: the space-time Burgers grid of ``BurgersSpaceTime``;
  * ``ElasticFSDTDataset``: the clamped plate of ``ElasticFSDT``.
"""

from __future__ import annotations

import math
import os

import numpy as np

__all__ = ["image_to_point_cloud", "PCVox", "nurbs_curve", "ParametricNURBS",
           "TopoDataset3D", "synthesize_topology_3d", "Burg2DXT",
           "ElasticFSDTDataset"]


def image_to_point_cloud(img, n_points=None):
    """Binary image -> (points[N,2] in [0,1]^2, unit outward normals[N,2])
    via Sobel gradients at boundary pixels (PCVox, e01:170-186)."""
    img = np.asarray(img, np.float64)
    kx = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float64)
    ky = kx.T
    from scipy import ndimage

    nx = ndimage.convolve(img, kx)
    ny = ndimage.convolve(img, ky)
    mag = np.hypot(nx, ny)
    # the Sobel response is a ~2px band straddling the interface; keep the
    # INSIDE ring only so the cloud is a single clean contour (otherwise
    # segment-length quadrature weights double-count both rings)
    bnd = (mag > 1e-9) & (img > 0.5)
    ys, xs = np.nonzero(bnd)
    ny_, nx_ = img.shape
    # per-axis normalization: a non-square image must still land in [0,1]^2
    pts = np.stack([xs / max(1, nx_ - 1), ys / max(1, ny_ - 1)], -1)
    nrm = np.stack([nx[bnd], ny[bnd]], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    # Sobel of the characteristic fn points inward->outward depending on
    # convention; chi=1 inside => gradient points inward; flip
    nrm = -nrm
    if n_points is not None and len(pts) > n_points:
        idx = np.linspace(0, len(pts) - 1, n_points).astype(int)
        pts, nrm = pts[idx], nrm[idx]
    return pts.astype(np.float32), nrm.astype(np.float32)


class PCVox:
    """Image file/array -> boundary point-cloud samples for the eikonal
    pipeline: (cloud[Np, 5], forcing[n, n, 1])."""

    n_samples = 100

    def __init__(self, img_or_path, domain_size=64, n_points=None):
        if isinstance(img_or_path, (str, os.PathLike)):
            import PIL.Image

            img = (np.asarray(PIL.Image.open(img_or_path).convert("L"))
                   > 0).astype(float)
        else:
            img = np.asarray(img_or_path, float)
        self.domain_size = domain_size
        pts, nrm = image_to_point_cloud(img, n_points)
        # order points along the contour (polar angle around the centroid)
        # before the segment-length quadrature: np.nonzero scan order jumps
        # across the shape at every row, inflating the area weights ~20x
        # (exact for star-shaped boundaries; the image masks here are)
        ang = np.arctan2(pts[:, 1] - pts[:, 1].mean(),
                         pts[:, 0] - pts[:, 0].mean())
        order = np.argsort(ang)
        pts, nrm = pts[order], nrm[order]
        d = np.linalg.norm(np.roll(pts, -1, 0) - pts, axis=-1)
        area = 0.5 * (d + np.roll(d, 1, 0))
        self.cloud = np.concatenate([pts, nrm, area[:, None]],
                                    -1).astype(np.float32)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        n = self.domain_size
        return self.cloud, np.zeros((n, n, 1), np.float32)


def nurbs_curve(control_points, weights=None, degree=3, n_samples=200,
                closed=True):
    """Sample a (rational) B-spline curve: de Boor evaluation on a uniform
    knot vector. Returns (points[N,2], outward normals[N,2], areas[N])."""
    P = np.asarray(control_points, np.float64)
    if weights is None:
        weights = np.ones(len(P))
    w = np.asarray(weights, np.float64)
    if len(w) != len(P):
        raise ValueError(f"{len(w)} weights for {len(P)} control points")
    if closed:
        P = np.concatenate([P, P[:degree]], axis=0)
        w = np.concatenate([w, w[:degree]])  # wrap like the points
    m = len(P)
    # uniform clamped/periodic knots
    if closed:
        knots = np.arange(m + degree + 1, dtype=np.float64)
        t0, t1 = knots[degree], knots[m]
    else:
        knots = np.concatenate([np.zeros(degree),
                                np.linspace(0, 1, m - degree + 1),
                                np.ones(degree)])
        t0, t1 = 0.0, 1.0

    def basis(i, k, t):
        if k == 0:
            return ((knots[i] <= t) & (t < knots[i + 1])).astype(float)
        left = np.zeros_like(t)
        right = np.zeros_like(t)
        den1 = knots[i + k] - knots[i]
        if den1 > 0:
            left = (t - knots[i]) / den1 * basis(i, k - 1, t)
        den2 = knots[i + k + 1] - knots[i + 1]
        if den2 > 0:
            right = (knots[i + k + 1] - t) / den2 * basis(i + 1, k - 1, t)
        return left + right

    ts = np.linspace(t0, t1 - 1e-9, n_samples)
    B = np.stack([basis(i, degree, ts) for i in range(m)])  # [m, N]
    num = (B * w[:, None]).T @ P
    den = (B * w[:, None]).sum(0)[:, None]
    pts = num / den
    # tangents by finite difference (periodic when closed; one-sided at
    # the endpoints of an open curve — np.roll there would span the whole
    # curve, giving arbitrary endpoint normals and ~10x inflated areas)
    nxt = np.roll(pts, -1, 0)
    prv = np.roll(pts, 1, 0)
    tang = nxt - prv
    if not closed:
        tang[0] = pts[1] - pts[0]
        tang[-1] = pts[-1] - pts[-2]
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    nrm = np.stack([tang[:, 1], -tang[:, 0]], -1)
    d = np.linalg.norm(nxt - pts, axis=-1)
    if not closed:
        d[-1] = 0.0  # no wrap segment on an open curve
    areas = 0.5 * (d + np.roll(d, 1, 0))
    if not closed:
        areas[0] = 0.5 * d[0]
        areas[-1] = 0.5 * d[-2]
    return (pts.astype(np.float32), nrm.astype(np.float32),
            areas.astype(np.float32))


class ParametricNURBS:
    """Ensemble of NURBS boundary clouds from randomized control polygons
    (the 09_airfoil.py parametric geometry pipeline, external-data-free;
    the sibling 02_sum.py/05_largenet.py/06_normals.py load the same
    cloud+normals+area stacks from checked-in npz instead).

    Samples are (cloud[Np, 5], forcing[n, n, 1], sink[n, n, 1]) triples —
    the IBNPoisson2D 'winding' batch contract. Forcing is ONES: the
    ensemble trains the immersed Poisson fill -lap(u) = 1 with u = 0
    inside the winding-number occupancy
    (02_sum.py:84 ``forcing = np.ones_like(self.domain)`` and the
    loss at 02_sum.py:131-185)."""

    def __init__(self, n_samples=64, n_control=8, n_points=150,
                 domain_size=32, seed=0):
        rng = np.random.default_rng(seed)
        self.domain_size = domain_size
        self.clouds = []
        for _ in range(n_samples):
            ang = np.linspace(0, 2 * math.pi, n_control, endpoint=False)
            r = rng.uniform(0.12, 0.3, n_control)
            ctrl = 0.5 + np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
            pts, nrm, area = nurbs_curve(ctrl, n_samples=n_points)
            self.clouds.append(np.concatenate(
                [pts, nrm, area[:, None]], -1).astype(np.float32))
        self.n_samples = n_samples

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        n = self.domain_size
        return (self.clouds[idx], np.ones((n, n, 1), np.float32),
                np.zeros((n, n, 1), np.float32))


def synthesize_topology_3d(n=32, n_bars=5, seed=0):
    """Random bar-lattice chi volume — a stand-in for SIMP topology npz
    outputs so the 3D pipeline runs data-free."""
    rng = np.random.default_rng(seed)
    chi = np.zeros((n, n, n))
    zz, yy, xx = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    for _ in range(n_bars):
        p0 = rng.uniform(0.15, 0.85, 3)
        p1 = rng.uniform(0.15, 0.85, 3)
        r = rng.uniform(0.04, 0.09)
        d = p1 - p0
        L2 = np.dot(d, d)
        t = np.clip(((xx - p0[0]) * d[0] + (yy - p0[1]) * d[1]
                     + (zz - p0[2]) * d[2]) / L2, 0, 1)
        px = p0[0] + t * d[0]
        py = p0[1] + t * d[1]
        pz = p0[2] + t * d[2]
        dist = np.sqrt((xx - px) ** 2 + (yy - py) ** 2 + (zz - pz) ** 2)
        chi[dist < r] = 1.0
    return chi


class TopoDataset3D:
    """Directory of npz topology files (array under key 'chi'/'arr_0') or a
    list of chi volumes -> 3D IBN samples (reference TopoDataset3D,
    IBN_3D.py:76-104)."""

    def __init__(self, source, domain_size=32):
        self.domain_size = n = domain_size
        vols = []
        if isinstance(source, (str, os.PathLike)):
            for fname in sorted(os.listdir(source)):
                if fname.endswith(".npz"):
                    z = np.load(os.path.join(source, fname))
                    key = "chi" if "chi" in z else z.files[0]
                    vols.append(np.asarray(z[key], float))
        else:
            vols = [np.asarray(v, float) for v in source]
        self.samples = []
        bc2 = np.zeros((n, n, n))
        bc2[[0, -1], :, :] = 1
        bc2[:, [0, -1], :] = 1
        bc2[:, :, [0, -1]] = 1
        for i, chi in enumerate(vols):
            if chi.shape != (n, n, n):
                raise ValueError(
                    f"topology volume {i} has shape {chi.shape}, expected "
                    f"({n}, {n}, {n}) — pass domain_size matching the npz "
                    "resolution (or resample the volumes)")
            domain = np.ones((n, n, n))
            self.samples.append(np.stack([domain, chi, bc2],
                                         -1).astype(np.float32))
        self.n_samples = len(self.samples)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        inputs = self.samples[idx]
        n = self.domain_size
        return inputs, np.zeros((n, n, n, 1), np.float32)


class Burg2DXT:
    """Space-time Burgers grid: channels (x, bc1, bc2, bc1_val), the masks
    -10 off the boundary; the initial condition cos(4 pi x) on the t = 0
    row, u = 0 on the x walls; forcing 0.01 / pi.

    x spans [-1, 1]: build the module with ``domain_lengths=(2.0, 1.0)`` so
    derivatives carry the physical scale (Gauss-point coordinates then run
    over [0, 2], so forcing and exact callables see x + 1)."""

    n_samples = 100

    def __init__(self, domain_size=64):
        n = domain_size
        x = np.linspace(-1, 1, n)
        t = np.linspace(0, 1, n)
        self.x, self.t = np.meshgrid(x, t)
        bc1 = np.full((n, n), -10.0)
        bc1_val = np.zeros((n, n))
        bc1[0, :] = 1.0
        bc1_val[0, :] = np.cos(4 * math.pi * x)
        bc2 = np.full((n, n), -10.0)
        bc2[:, 0] = 1
        bc2[:, -1] = 1
        self.inputs = np.stack([self.x, bc1, bc2, bc1_val],
                               -1).astype(np.float32)
        self.forcing = np.full((n, n, 1), 0.01 / math.pi, np.float32)
        self.initial_guess = np.tile(bc1_val[0], (n, 1)).astype(np.float32)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        return self.inputs, self.forcing


class ElasticFSDTDataset:
    """The FSDT plate: channels (x, y, bc1, bc2, bc3), each bc the clamped
    walls; forcing 1 / Re."""

    n_samples = 100

    def __init__(self, domain_size=64, Re=1):
        n = domain_size
        x = np.linspace(0, 1, n)
        self.x, self.y = np.meshgrid(x, x)
        walls = np.zeros((n, n))
        walls[[0, -1], :] = 1.0
        walls[:, [0, -1]] = 1.0
        self.bc1 = walls
        self.bc2 = walls.copy()
        self.bc3 = walls.copy()
        self.Re = Re
        self.inputs = np.stack([self.x, self.y, self.bc1, self.bc2,
                                self.bc3], -1).astype(np.float32)
        self.forcing = np.full((n, n, 1), 1.0 / Re, np.float32)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        return self.inputs, self.forcing
