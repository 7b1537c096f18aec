#!/usr/bin/env python3
"""The JAX package's two residuals of chip_smoke.py's slice D3, on a CPU.

Slice D3 solves bench.py's variable-nu (54x contrast) Poisson problem by
14 iterations of CG on the extracted fine-level stencil, preconditioned by
the multigrid V-cycle on assembled stencils (levels n ... 33), and holds
the solution to its relative residual under two operators: the stencil it
iterated on and the element-path operator the stencil was extracted from.
This script runs the same solve in the JAX package (the stencil applied by
XLA; its Pallas kernel runs only on a TPU or in interpret mode) and prints
one JSON line per grid: both residuals, their ratio and the extraction
defect, beside the same two residuals of D1 (CG on the element-path
operator with the same V-cycle).

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_stencil.py [n ...]

Default grid: 129 (a few seconds); 513 is bench.py's and chip_smoke's.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

ITERS = 14


def _nu(n: int) -> np.ndarray:
    x = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(x, x, indexing="xy")
    g = (np.cos(2 * np.pi * X) * np.cos(np.pi * Y)
         + 0.5 * np.sin(3 * np.pi * X * Y))
    return np.exp(2.0 * g / np.abs(g).max()).astype(np.float32)


class _Instance:
    """nu; source (u = 1) on the left column, sink (u = 0) on the right;
    zero forcing."""

    def __init__(self, nu):
        m = nu.shape[0]
        b1 = np.zeros((m, m), np.float32)
        b1[:, 0] = 1
        b2 = np.zeros((m, m), np.float32)
        b2[:, -1] = 1
        self.inputs = np.stack([nu, b1, b2], -1).astype(np.float32)
        self.forcing = np.zeros((m, m, 1), np.float32)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def d3_residuals(n: int) -> dict:
    import jax
    import jax.numpy as jnp

    from diffnet_tpu.models.field import DirectField
    from diffnet_tpu.pde import Poisson2D
    from diffnet_tpu.train import multigrid_preconditioner
    from diffnet_tpu.train.stencil import extract_verified, stencil_matvec

    t0 = time.perf_counter()
    ds_fine = _Instance(_nu(n))
    cache = {}

    def factory(m_n):
        if m_n not in cache:
            ds = ds_fine if m_n == n else _Instance(
                np.ones((m_n, m_n), np.float32))
            cache[m_n] = Poisson2D(DirectField((m_n, m_n)), ds,
                                   domain_size=m_n, batch_size=1,
                                   loss_type="resmin")
        return cache[m_n]

    m = factory(n)
    inputs = jnp.asarray(ds_fine.inputs)[None]
    forcing = jnp.asarray(ds_fine.forcing)[None]
    b0 = m.residual_for_field(jnp.zeros((1, n, n)), inputs, forcing)[0]

    def A_plain(v):
        return m.residual_for_field(v[None], inputs, forcing)[0] - b0

    bc = np.zeros((n, n), np.float32)
    bc[:, [0, -1]] = 1.0
    b = jnp.asarray(np.where(bc > 0.5, 0.0, np.random.default_rng(0)
                             .standard_normal((n, n))).astype(np.float32))
    M, _ = multigrid_preconditioner(factory, n, n_coarse=min(33, n),
                                    inputs_per_level="restrict")
    Cf, defect = extract_verified(A_plain, (n, n))

    def A_stencil(v):
        return stencil_matvec(Cf, v)

    def relres(A, u):
        return float(jnp.linalg.norm(A(u) - b) / jnp.linalg.norm(b))

    out = {"figure": "D3_residual_gap", "grid": n, "iters": ITERS,
           "stencil_defect": defect}
    for name, A in (("D1", A_plain), ("D3", A_stencil)):
        u, _ = jax.jit(lambda b, A=A: jax.scipy.sparse.linalg.cg(
            A, b, tol=0.0, maxiter=ITERS, M=M))(b)
        own, plain = relres(A, u), relres(A_plain, u)
        out[name] = {"relres_own_op": own, "relres_plain_op": plain,
                     "plain_over_own": plain / own}
    out["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    for arg in sys.argv[1:] or ["129"]:
        print(json.dumps(d3_residuals(int(arg))), flush=True)
