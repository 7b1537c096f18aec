"""Single-instance datasets (channels-last numpy), ported from
``diffnet_tpu/data/single_instances.py``.

Each dataset returns the same sample `n_samples` times (one epoch = n
gradient steps on one instance) as ``(inputs[(D,) H, W, C], forcing[(D,)
H, W, 1])`` float32, channels last: ``inputs[..., 0]`` = domain/nu,
``[..., 1]`` = bc1 (source, u := 1), ``[..., 2]`` = bc2 (sink, u := 0).
3D arrays are ``[z, y, x]``.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .gen_input import generate_diffusivity_tensor

__all__ = [
    "SingleInstanceDataset", "Rectangle", "RectangleManufactured",
    "RectangleManufacturedNonZeroBC", "SpaceTimeRectangleManufactured",
    "AdvDiff1dRectangle", "AdvDiff2dRectangle", "AllenCahnIceMeltRectangle",
    "RectangleHelmholtzManufactured", "RectangleHelmholtzDeltaForce",
    "RectangleManufacturedStokes", "RectangleIM", "RectangleIMBack",
    "CircleIMBack", "LShaped", "ImageIMBack", "Disk", "KLSumSingleInstance",
    "Cuboid", "CuboidManufactured", "load_raw", "VoxelIMBackRAW"]


def _grid(n):
    x = np.linspace(0, 1, n)
    return np.meshgrid(x, x)


class SingleInstanceDataset:
    """Base: subclasses set .domain/.bc1/.bc2 (+ extra channels via
    `extra_channels`) and .forcing."""

    n_samples = 100

    def extra_channels(self):
        return []

    def __len__(self):
        return self.n_samples

    def __getitem__(self, index):
        chans = [self.domain, self.bc1, self.bc2] + list(self.extra_channels())
        inputs = np.stack(chans, axis=-1).astype(np.float32)
        forcing = np.asarray(self.forcing, np.float32)[..., None]
        return inputs, forcing


class Rectangle(SingleInstanceDataset):
    """Unit square, source on the top row, sink on the bottom row."""

    n_samples = 6000

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n)); self.bc1[0, :] = 1
        self.bc2 = np.zeros((n, n)); self.bc2[-1, :] = 1
        self.forcing = np.zeros((n, n))


class RectangleManufactured(SingleInstanceDataset):
    """MMS: f = 2 pi^2 sin(pi x) sin(pi y), Dirichlet-0 on all four walls."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n))
        self.bc2 = np.zeros((n, n))
        self.bc2[[0, -1], :] = 1
        self.bc2[:, [0, -1]] = 1
        self.xx, self.yy = _grid(n)
        self.forcing = 2.0 * math.pi**2 * np.sin(math.pi * self.xx) * np.sin(
            math.pi * self.yy)

    @staticmethod
    def exact(x, y):
        return np.sin(math.pi * x) * np.sin(math.pi * y)


def _walls_2d(n: int) -> np.ndarray:
    """1 on the four walls of an n^2 node grid."""
    bc = np.zeros((n, n))
    bc[[0, -1], :] = 1
    bc[:, [0, -1]] = 1
    return bc


class RectangleManufacturedNonZeroBC(SingleInstanceDataset):
    """u_exact = exp(-pi x) sin(pi y): bc1 the left and right walls (the
    nonzero Dirichlet data), bc2 the top and bottom rows; no forcing."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n)); self.bc1[:, [0, -1]] = 1
        self.bc2 = np.zeros((n, n)); self.bc2[[0, -1], :] = 1
        self.xx, self.yy = _grid(n)
        self.om = np.pi
        self.u_exact = np.exp(-self.om * self.xx) * np.sin(self.om * self.yy)
        self.forcing = np.zeros((n, n))


class SpaceTimeRectangleManufactured(SingleInstanceDataset):
    """Space-time heat, the y axis time: bc1 the initial row (y = 0), bc2
    the side walls; u0 = sin(pi x) exp(-0.5 y), diffusivity 0.1. ``domain``
    and ``initial_guess`` are drawn from ``np.random.default_rng(seed)``."""

    def __init__(self, domain_size=64, seed=0):
        n = domain_size
        rng = np.random.default_rng(seed)
        self.bc1 = np.zeros((n, n)); self.bc1[0, :] = 1
        self.bc2 = np.zeros((n, n)); self.bc2[:, [0, -1]] = 1
        xx, yy = _grid(n)
        self.decay_rt = 0.5
        self.u0 = np.sin(math.pi * xx) * np.exp(-self.decay_rt * yy)
        self.diffusivity = 0.1
        self.forcing = np.zeros_like(xx)
        self.domain = rng.normal(0, 1.0, size=(n, n))
        self.initial_guess = (np.tile(self.u0[0, :], (n, 1))
                              + 0.1 * rng.random((n, n)))


class AdvDiff1dRectangle(SingleInstanceDataset):
    """1D advection-diffusion embedded in 2D: Dirichlet side walls,
    f = 1."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n))
        self.bc2 = np.zeros((n, n)); self.bc2[:, [0, -1]] = 1
        self.xx, self.yy = _grid(n)
        self.forcing = np.ones((n, n))


class AdvDiff2dRectangle(SingleInstanceDataset):
    """2D advection skew to the mesh: the left wall's inlet (bc1, u = 1)
    above y = 0.2, u = 0 below it and on the bottom row (bc2)."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n))
        self.bc2 = np.zeros((n, n))
        cut = int(0.2 * n)
        self.bc1[cut:, 0] = 1
        self.bc2[:cut, 0] = 1
        self.bc2[0, :] = 1
        self.xx, self.yy = _grid(n)
        self.forcing = np.zeros((n, n))


class AllenCahnIceMeltRectangle(SingleInstanceDataset):
    """Allen-Cahn ice melt in space-time: a tanh interface as the initial
    row (bc1); A = 16, Cn = 0.1, D = 1, k = 2."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.ac_A, self.ac_Cn, self.ac_D, self.ac_k = 16.0, 0.1, 1.0, 2.0
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n)); self.bc1[0, :] = 1
        self.bc2 = np.zeros((n, n))
        x = np.linspace(0, 1, n)
        self.xx, self.yy = _grid(n)
        thick = self.ac_Cn * np.sqrt(2.0 / self.ac_A)
        u_t0 = 0.5 + 0.5 * np.tanh((x - 0.5) / thick)
        self.u0 = np.zeros((n, n)); self.u0[0, :] = u_t0
        self.initial_guess = np.tile(u_t0[None, :], (n, 1))
        self.forcing = np.zeros((n, n))


class RectangleHelmholtzManufactured(SingleInstanceDataset):
    """Helmholtz MMS: u = sin(pi x) sin(pi y), f = (2 pi^2 - k^2) u,
    Dirichlet-0 on the walls; k = ``khh``."""

    def __init__(self, domain_size=64, khh=0.5):
        n = domain_size
        self.khh = khh
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n))
        self.bc2 = _walls_2d(n)
        self.xx, self.yy = _grid(n)
        self.forcing = (2.0 * math.pi**2 - khh**2) * np.sin(
            math.pi * self.xx) * np.sin(math.pi * self.yy)

    @staticmethod
    def exact(x, y):
        return np.sin(math.pi * x) * np.sin(math.pi * y)


class RectangleHelmholtzDeltaForce(SingleInstanceDataset):
    """Helmholtz with a near-delta Gaussian source at (0.1875, 0.1875),
    k = 1/8, Dirichlet-0 on the walls."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.khh = 1.0 / 8.0
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n))
        self.bc2 = _walls_2d(n)
        xx, yy = _grid(n)
        mu, sig = 0.1875, 0.05
        self.forcing = np.exp(-0.5 * ((xx - mu) / sig) ** 2
                              - 0.5 * ((yy - mu) / sig) ** 2) / (
                                  2 * np.pi * sig * sig)


class RectangleManufacturedStokes(SingleInstanceDataset):
    """The Stokes MMS masks: bc2 the top and bottom rows, f = 2 pi^2
    sin(pi x) sin(pi y)."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n))
        self.bc2 = np.zeros((n, n)); self.bc2[[0, -1], :] = 1
        self.xx, self.yy = _grid(n)
        self.forcing = 2.0 * math.pi**2 * np.sin(math.pi * self.xx) * np.sin(
            math.pi * self.yy)


class RectangleIM(SingleInstanceDataset):
    """An immersed rectangle solved within the object: source on its first
    row, sink one row past its last. The sink's row lies outside the
    object (domain 0 there): a parity quirk kept deliberately."""

    n_samples = 200

    def __init__(self, domain_size=64):
        n = domain_size
        x0, y0, w, h = 10, 10, 30, 50
        self.domain = np.zeros((n, n)); self.domain[y0:y0 + h, x0:x0 + w] = 1.0
        self.bc1 = np.zeros((n, n)); self.bc1[y0, x0:x0 + w] = 1
        self.bc2 = np.zeros((n, n)); self.bc2[y0 + h, x0:x0 + w] = 1
        self.forcing = np.zeros((n, n))


class RectangleIMBack(SingleInstanceDataset):
    """An immersed rectangle in a background grid: the object is the bc1
    region (u := 1), the walls the sink."""

    n_samples = 200

    def __init__(self, domain_size=64):
        n = domain_size
        x0, y0, w, h = 10, 10, 30, 20
        self.domain = np.ones((n, n)); self.domain[y0:y0 + h, x0:x0 + w] = 0.0
        self.bc1 = np.zeros((n, n)); self.bc1[y0:y0 + h, x0:x0 + w] = 1.0
        self.bc2 = _walls_2d(n)
        self.forcing = np.zeros((n, n))


class CircleIMBack(SingleInstanceDataset):
    """An immersed circle by the sign of its analytic SDF. The pixel
    coordinates are ``linspace(0, 1, n) * n``, spanning [0, n], so the
    circle's parameters scale by n / (n - 1) against pixel indices: a
    parity quirk kept deliberately."""

    def __init__(self, domain_size=64):
        n = domain_size
        cx, cy, r = 15, 40, 15
        x = np.linspace(0, 1, n) * n
        xx, yy = np.meshgrid(x, x)
        zz = (xx - cx) ** 2 + (yy - cy) ** 2 - r**2
        self.domain = (zz > 0.0).astype(float)
        self.bc1 = (zz < 0.0).astype(float)
        self.bc2 = _walls_2d(n)
        self.forcing = np.zeros((n, n))


class LShaped(SingleInstanceDataset):
    """An L-shaped domain solved within the object, forcing 10 chi, the
    sink on its outline. The far-edge sink indices are one past the
    object: the parity quirk of ``RectangleIM``, kept deliberately."""

    n_samples = 200

    def __init__(self, domain_size=64):
        n = domain_size
        p = [5, 5, 50, 20, 50, 20]
        self.domain = np.zeros((n, n))
        self.domain[p[0]:p[0] + p[2], p[1]:p[1] + p[3]] = 1.0
        self.domain[p[0]:p[0] + p[5], p[1]:p[1] + p[4]] = 1.0
        self.bc1 = np.zeros((n, n))
        bc2 = np.zeros((n, n))
        bc2[p[0]:p[0] + p[2], p[1]] = 1
        bc2[p[0] + p[2], p[1]:p[1] + p[3]] = 1
        bc2[p[0] + p[5]:p[0] + p[2], p[1] + p[3]] = 1
        bc2[p[0] + p[5], p[1] + p[3]:p[1] + p[4]] = 1
        bc2[p[0]:p[0] + p[5], p[1] + p[4]] = 1
        bc2[p[0], p[1]:p[1] + p[4]] = 1
        self.bc2 = bc2
        self.forcing = self.domain.copy() * 10


def _load_binary_image(filename):
    """A binary mask (pixels > 0) of a grey-scale image file. PIL is
    imported here only, so the package needs it only for images."""
    import PIL.Image

    ext = os.path.splitext(filename)[1]
    if ext not in (".png", ".jpg", ".bmp", ".tiff"):
        raise ValueError("invalid extension; extension not supported")
    img = PIL.Image.open(filename).convert("L")
    return (np.asarray(img) > 0).astype(float)


class ImageIMBack(SingleInstanceDataset):
    """A binary image as an immersed object: solve outside it, u := 1
    inside, the walls the sink. ``domain_size`` is accepted and unused: the
    masks keep the image's resolution (a parity quirk kept
    deliberately)."""

    def __init__(self, filename, domain_size=64):
        img = _load_binary_image(filename)
        self.domain = 1 - img
        self.bc1 = np.zeros_like(self.domain)
        self.bc1[(1 - self.domain).astype(bool)] = 1
        self.bc2 = np.zeros_like(self.domain)
        self.bc2[:, [0, -1]] = 1; self.bc2[[0, -1], :] = 1
        self.forcing = np.zeros_like(self.domain)


class Disk(ImageIMBack):
    """``ImageIMBack`` with unit forcing."""

    def __init__(self, filename, domain_size=64):
        super().__init__(filename, domain_size)
        self.forcing = np.ones_like(self.domain)


class KLSumSingleInstance(SingleInstanceDataset):
    """One Karhunen-Loeve diffusivity nu = exp(KL sum) of the coefficients
    in a text file: source (u := 1) on the left wall, sink (u := 0) on the
    right, no forcing."""

    n_samples = 1000

    def __init__(self, coeff_file, domain_size=64):
        if not os.path.exists(coeff_file):
            raise FileNotFoundError(
                "Single instance: Wrong path to coefficient file.")
        self.coeff = np.loadtxt(coeff_file, dtype=np.float32)
        n = self.domain_size = domain_size
        self.nu = generate_diffusivity_tensor(
            self.coeff, output_size=n).squeeze()
        self.domain = self.nu
        self.bc1 = np.zeros((n, n)); self.bc1[:, 0] = 1
        self.bc2 = np.zeros((n, n)); self.bc2[:, -1] = 1
        self.forcing = np.zeros((n, n))


def _walls_3d(n: int) -> np.ndarray:
    """1 on the six faces of an n^3 node grid."""
    bc = np.zeros((n, n, n))
    bc[[0, -1], :, :] = 1
    bc[:, [0, -1], :] = 1
    bc[:, :, [0, -1]] = 1
    return bc


class Cuboid(SingleInstanceDataset):
    """Unit cube, source on the z = 0 face, sink on the z = 1 face."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n, n))
        self.bc1 = np.zeros((n, n, n)); self.bc1[0, :, :] = 1
        self.bc2 = np.zeros((n, n, n)); self.bc2[-1, :, :] = 1
        self.forcing = np.zeros((n, n, n))


class CuboidManufactured(SingleInstanceDataset):
    """3D MMS: f = 19 pi^2 sin(pi x) sin(3 pi y) sin(3 pi z), Dirichlet-0 on
    all six faces."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n, n))
        self.bc1 = np.zeros((n, n, n))
        self.bc2 = _walls_3d(n)
        x = np.linspace(0, 1, n)
        zz, yy, xx = np.meshgrid(x, x, x, indexing="ij")
        self.xx, self.yy, self.zz = xx, yy, zz
        self.forcing = self.forcing_func(xx, yy, zz)

    @staticmethod
    def forcing_func(x, y, z):
        return 19.0 * math.pi**2 * np.sin(math.pi * x) * np.sin(
            3 * math.pi * y) * np.sin(3 * math.pi * z)

    @staticmethod
    def exact(x, y, z):
        return np.sin(math.pi * x) * np.sin(3 * math.pi * y) * np.sin(
            3 * math.pi * z)


def load_raw(file_prefix):
    """Read a ``<prefix>inouts.raw`` uint8 voxelisation and its
    ``<prefix>VoxelConfig.txt`` (a header line, the bounding box's min and
    max corners, the voxel counts, the voxel size). Returns ``(inout,
    numDiv, gridSize, bBoxMin)``, ``inout`` the 0/1 occupancy in Fortran
    order."""
    with open(file_prefix + "VoxelConfig.txt") as cfg:
        cfg.readline()
        bmin = np.array([float(v) for v in cfg.readline().split()])
        cfg.readline()   # the bounding box's max corner
        num_div = np.array([int(v) for v in cfg.readline().split()])
        grid_size = np.array([float(v) for v in cfg.readline().split()])
    raw = np.fromfile(file_prefix + "inouts.raw", dtype=np.uint8)
    inout = (raw / 254.0 > 0.25).astype(float)
    inout = np.reshape(inout, num_div, order="F")
    return inout, num_div, grid_size, bmin


class VoxelIMBackRAW(SingleInstanceDataset):
    """A voxelised object embedded at `offset` into an n^3 background domain:
    the object is the source (bc1), the six faces the sink (bc2). An object
    larger than ``domain_size - offset`` is clipped to the window."""

    def __init__(self, file_prefix, domain_size=64, offset=32):
        vox, _, _, _ = load_raw(file_prefix)
        n = domain_size
        sx, sy, sz = (min(s, n - offset) for s in vox.shape)
        o = offset
        self.domain = np.ones((n, n, n))
        self.domain[o:o + sx, o:o + sy, o:o + sz] = 1 - vox[:sx, :sy, :sz]
        self.bc1 = np.zeros((n, n, n))
        self.bc1[o:o + sx, o:o + sy, o:o + sz] = vox[:sx, :sy, :sz]
        self.bc2 = _walls_3d(n)
        self.forcing = np.zeros((n, n, n))
