"""Flow datasets: Stokes MMS, NS lid-driven cavity, NS flow past an object
(port of ``diffnet_tpu/data/flow.py``; numpy only).

Channels-last, as in the JAX package: ``inputs[..., (x, y, bc1, bc2,
bc3[, nu or chi])]``; ``forcing[..., 0]`` is ``1 / Re``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["StokesMMSDataset", "NSLDCDataset", "FlowPastObjectDataset",
           "FlowPastObjectEnsemble", "NSFPSChannelDataset",
           "synthetic_obstacles"]


class _FlowBase:
    n_samples = 100

    def __len__(self):
        return self.n_samples

    def __getitem__(self, index):
        inputs = np.stack(self.channels, axis=-1).astype(np.float32)
        forcing = np.full(inputs.shape[:-1] + (1,), 1.0 / self.Re, np.float32)
        return inputs, forcing


class StokesMMSDataset(_FlowBase):
    """All-wall Dirichlet for u (bc1) and v (bc2); pressure pin at node
    (0, 0) (bc3)."""

    def __init__(self, domain_size=64, Re=1):
        n = domain_size
        x = np.linspace(0, 1, n)
        self.x, self.y = np.meshgrid(x, x)
        walls = np.zeros((n, n))
        walls[[0, -1], :] = 1.0
        walls[:, [0, -1]] = 1.0
        self.bc1 = walls
        self.bc2 = walls.copy()
        self.bc3 = np.zeros((n, n))
        self.bc3[0, 0] = 1.0
        self.Re = Re
        self.channels = [self.x, self.y, self.bc1, self.bc2, self.bc3]


class NSLDCDataset(_FlowBase):
    """Lid-driven cavity: all walls Dirichlet for u and v, pressure pinned
    at the corner; an extra seeded random nu channel."""

    def __init__(self, domain_lengths=(1.0, 1.0), domain_sizes=(32, 32),
                 Re=1, seed=0):
        nx, ny = domain_sizes
        x = np.linspace(0, domain_lengths[0], nx)
        y = np.linspace(0, domain_lengths[1], ny)
        self.x, self.y = np.meshgrid(x, y)
        walls = np.zeros((ny, nx))
        walls[[0, -1], :] = 1.0
        walls[:, [0, -1]] = 1.0
        self.bc1 = walls
        self.bc2 = walls.copy()
        self.bc3 = np.zeros((ny, nx))
        self.bc3[0, 0] = 1.0
        self.Re = Re
        self.nu = np.random.default_rng(seed).normal(0, 1.0, (ny, nx))
        self.channels = [self.x, self.y, self.bc1, self.bc2, self.bc3,
                         self.nu]


class FlowPastObjectDataset(_FlowBase):
    """Channel flow past an embedded object chi (image or mask): parabolic
    inlet profile on the left, no-slip on the object and the top and bottom
    walls, pressure pinned at the outlet's middle node."""

    def __init__(self, chi, domain_lengths=(4.0, 1.0), Re=100):
        chi = np.asarray(chi, np.float64)
        ny, nx = chi.shape
        x = np.linspace(0, domain_lengths[0], nx)
        y = np.linspace(0, domain_lengths[1], ny)
        self.x, self.y = np.meshgrid(x, y)
        H = domain_lengths[1]
        inlet = 4.0 * self.y[:, 0] * (H - self.y[:, 0]) / H**2
        bc_u = np.zeros((ny, nx))
        bc_u[:, 0] = 1.0           # inlet (value from the u_bc profile)
        bc_u[[0, -1], :] = 1.0     # walls
        bc_u += chi                # object no-slip
        bc_v = bc_u.copy()
        bc_p = np.zeros((ny, nx))
        bc_p[ny // 2, -1] = 1.0
        self.bc1 = np.clip(bc_u, 0, 1)
        self.bc2 = np.clip(bc_v, 0, 1)
        self.bc3 = bc_p
        self.Re = Re
        self.u_bc = np.zeros((ny, nx), np.float32)
        self.u_bc[:, 0] = inlet
        self.channels = [self.x, self.y, self.bc1, self.bc2, self.bc3, chi]


class NSFPSChannelDataset(_FlowBase):
    """Channel flow past an embedded square block (L12 x H6 channel,
    parabolic inlet ``u = 1 - (2y/H - 1)^2``, no-slip top and bottom walls
    and obstacle, the outlet pressure column pinned to 0, u and v free at
    the outlet). The block is masked by exact node coordinates (default:
    x in [2, 3], y in [2.5, 3.5]).

    Channels: (x, y, bc1, bc2, bc3); ``u_bc`` carries the inlet profile.
    """

    def __init__(self, domain_lengths=(12.0, 6.0), domain_sizes=(97, 49),
                 obstacle=((2.0, 2.5), (3.0, 3.5)), Re=30):
        Lx, Ly = domain_lengths
        nx, ny = domain_sizes
        x = np.linspace(0, Lx, nx)
        y = np.linspace(0, Ly, ny)
        self.x, self.y = np.meshgrid(x, y)
        (x0, y0), (x1, y1) = obstacle
        eps = 1e-9
        chi = ((self.x >= x0 - eps) & (self.x <= x1 + eps)
               & (self.y >= y0 - eps) & (self.y <= y1 + eps))
        self.chi = chi.astype(np.float64)

        walls_inlet = np.zeros((ny, nx))
        walls_inlet[[0, -1], :] = 1.0   # top and bottom walls
        walls_inlet[:, 0] = 1.0         # inlet
        bc_uv = np.clip(walls_inlet + self.chi, 0, 1)
        self.bc1 = bc_uv
        self.bc2 = bc_uv.copy()
        self.bc3 = np.zeros((ny, nx))
        self.bc3[:, -1] = 1.0           # outlet p = 0 (whole column)

        self.Re = Re
        self.u_bc = np.zeros((ny, nx), np.float32)
        self.u_bc[:, 0] = 1.0 - (2.0 * y / Ly - 1.0) ** 2
        self.v_bc = np.zeros((ny, nx), np.float32)
        self.p_bc = np.zeros((ny, nx), np.float32)
        self.channels = [self.x, self.y, self.bc1, self.bc2, self.bc3]


def synthetic_obstacles(n_samples, shape=(64, 128), domain_lengths=(4.0, 1.0),
                        seed=0):
    """Seeded random ellipse obstacle masks in the front half of the
    channel."""
    ny, nx = shape
    Lx, Ly = domain_lengths
    x = np.linspace(0, Lx, nx)
    y = np.linspace(0, Ly, ny)
    xx, yy = np.meshgrid(x, y)
    rng = np.random.default_rng(seed)
    chis = []
    for _ in range(n_samples):
        cx = rng.uniform(0.6, 1.6)
        cy = rng.uniform(0.35 * Ly, 0.65 * Ly)
        rx = rng.uniform(0.12, 0.3)
        ry = rng.uniform(0.06, 0.14) * Ly
        th = rng.uniform(-0.3, 0.3)
        dx, dy = xx - cx, yy - cy
        xr = np.cos(th) * dx + np.sin(th) * dy
        yr = -np.sin(th) * dx + np.cos(th) * dy
        chis.append(((xr / rx) ** 2 + (yr / ry) ** 2 < 1.0).astype(float))
    return chis


class FlowPastObjectEnsemble(_FlowBase):
    """Parametric flow past an object: an ensemble of obstacle masks, each
    sample a full channel-flow instance with the object folded into the
    no-slip masks."""

    def __init__(self, chis, domain_lengths=(4.0, 1.0), Re=100):
        self.instances = [FlowPastObjectDataset(c, domain_lengths, Re)
                          for c in chis]
        self.Re = Re
        self.u_bc = self.instances[0].u_bc  # inlet profile (shared geometry)
        self.n_samples = len(self.instances)

    def __getitem__(self, index):
        if not -len(self.instances) <= index < len(self.instances):
            # raising (not wrapping) ends the legacy __getitem__ iteration
            raise IndexError(index)
        return self.instances[index][0]
