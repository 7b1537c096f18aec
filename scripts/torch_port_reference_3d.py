#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's 3D checks are held to.

Runs the JAX package on the CPU and prints one JSON line per figure:

  E1  examples/poisson_3d.py's MMS run at its default 17^3
      (CuboidManufactured, resmin, mms_dirichlet, LBFGS 60 epochs x 10
      iterations): the final rel L2 against the exact solution;
  F   the 129^3 variable-nu MG-CG solve of chip_smoke.py's slice F: nu =
      exp(2g) of a smooth seeded g (``smooth_nu_3d``), source on the x = 0
      face and sink on the x = 1 face, zero forcing, levels 129-65-33-17-9
      (n_coarse=9), Chebyshev of degree 3, inputs restricted from the fine
      level, 14 CG iterations at tol=0 on one seeded right-hand side: the
      relative residual.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_3d.py [e1] [f]

chip_smoke.py keeps its own copy of ``smooth_nu_3d`` and of the right-hand
side (it imports no JAX); the two must stay the same.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def smooth_nu_3d(n: int, seed: int = 0) -> np.ndarray:
    """nu = exp(2g), g a sum of four seeded cosine modes scaled to
    max |g| = 1 (a contrast of up to e^4, about 55x), on [z, y, x] nodes."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    g = np.zeros((n, n, n))
    for _ in range(4):
        kx, ky, kz = rng.integers(1, 4, size=3)
        px, py, pz = rng.uniform(0.0, 2 * np.pi, size=3)
        g += (rng.uniform(0.5, 1.0) * np.cos(np.pi * kx * X + px)
              * np.cos(np.pi * ky * Y + py) * np.cos(np.pi * kz * Z + pz))
    g /= np.abs(g).max()
    return np.exp(2.0 * g).astype(np.float32)


def varnu_instance(nu: np.ndarray):
    """(inputs [n, n, n, 3], forcing [n, n, n, 1]): source (u = 1) on the
    x = 0 face, sink (u = 0) on the x = 1 face, zero forcing."""
    n = nu.shape[0]
    b1 = np.zeros((n, n, n), np.float32)
    b1[:, :, 0] = 1
    b2 = np.zeros((n, n, n), np.float32)
    b2[:, :, -1] = 1
    return (np.stack([nu, b1, b2], -1).astype(np.float32),
            np.zeros((n, n, n, 1), np.float32))


def solve_rhs(n: int) -> np.ndarray:
    """The seeded right-hand side, zero on the Dirichlet faces."""
    b = np.random.default_rng(0).standard_normal((n, n, n))
    b[:, :, [0, -1]] = 0.0
    return b.astype(np.float32)


def e1() -> dict:
    from diffnet_tpu.data.single_instances import CuboidManufactured
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import Poisson3D
    from diffnet_tpu.train import Trainer

    n = 17
    ds = CuboidManufactured(domain_size=n)
    ds.n_samples = 1
    m = Poisson3D(DirectField((n, n, n), init=np.zeros((n, n, n))), ds,
                  domain_size=n, batch_size=1, loss_type="resmin",
                  exact_solution=ds.exact, forcing=ds.forcing_func,
                  mms_dirichlet=True)
    t0 = time.perf_counter()
    st = Trainer(max_epochs=60, optimizer="lbfgs", lbfgs_max_iter=10).fit(m)
    eL2, _, uex = m.calc_l2_err(m.network.apply(st.params)[0])
    return {"figure": "E1", "grid": n, "final_rel_l2": float(eL2 / uex),
            "seconds": time.perf_counter() - t0}


class _Instance:
    def __init__(self, inputs, forcing):
        self.inputs, self.forcing = inputs, forcing

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def f(n: int = 129, iters: int = 14) -> dict:
    import jax.numpy as jnp
    from jax.scipy.sparse.linalg import cg

    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import Poisson3D
    from diffnet_tpu.train import multigrid_preconditioner

    nu = smooth_nu_3d(n)
    fine = _Instance(*varnu_instance(nu))
    cache = {}

    def factory(m_n):
        if m_n not in cache:
            ds = fine if m_n == n else _Instance(*varnu_instance(
                np.ones((m_n,) * 3, np.float32)))
            cache[m_n] = Poisson3D(DirectField((m_n,) * 3), ds,
                                   domain_size=m_n, batch_size=1,
                                   loss_type="resmin")
        return cache[m_n]

    m = factory(n)
    inputs = jnp.asarray(fine.inputs)[None]
    forcing = jnp.asarray(fine.forcing)[None]
    b0 = m.residual_for_field(jnp.zeros((1, n, n, n)), inputs, forcing)[0]

    def A(v):
        return m.residual_for_field(v[None], inputs, forcing)[0] - b0

    t0 = time.perf_counter()
    M, info = multigrid_preconditioner(factory, n, n_coarse=9, nsd=3,
                                       inputs_per_level="restrict")
    setup = time.perf_counter() - t0
    b = jnp.asarray(solve_rhs(n))
    t0 = time.perf_counter()
    u, _ = cg(A, b, tol=0.0, maxiter=iters, M=M)
    rel = float(jnp.linalg.norm(A(u) - b) / jnp.linalg.norm(b))
    return {"figure": "F", "grid": n, "iters": iters,
            "levels": [int(v) for v in info["levels"]],
            "nu_contrast": float(nu.max() / nu.min()), "relres": rel,
            "setup_s": setup, "solve_s": time.perf_counter() - t0}


if __name__ == "__main__":
    which = sys.argv[1:] or ["e1", "f"]
    for name in which:
        print(json.dumps({"e1": e1, "f": f}[name]()), flush=True)
