#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's flow check is held to.

Runs the JAX package on the CPU on chip_smoke.py's slice G1: the
lid-driven cavity at Re = 100 on the 129^2 node grid (128 x 128 elements,
the reference's grid), regularised lid, ``NavierStokes`` with its default
mean-control pressure gauge, solved from rest by ``ns_newton_solve`` with
15 Newton iterations and the defaults (gmres_iters 40, restart 10,
n_coarse 9, tol 1e-6). It prints one JSON line: the final |F|, the
accepted Newton steps, the midline extrema (min of u on the column
x = 0.5, min and max of v on the row y = 0.5), the pressure on the row
y = 0.5 (min and max, which a constant drift of the gauge would move) and
the seconds.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_flow.py

The residual is JAX's XLA path (``fused_kernels=False``): its Pallas kernel
runs only on a TPU or in interpret mode, and the two solves agree to 6e-8
(tests/test_pallas_kernel.py::test_ns_newton_solve_with_fused_kernels).
chip_smoke.py keeps its own copy of the problem and of ``midline_figures``
(it imports no JAX); the two must stay the same.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

G1_GRID, G1_RE, G1_NEWTON_ITERS = 129, 100.0, 15


def midline_figures(u, v, p) -> dict:
    """The figures a solve is held to, from nodal [n, n] fields."""
    m = u.shape[0] // 2
    return {"u_min_x05": float(u[:, m].min()),
            "v_min_y05": float(v[m, :].min()),
            "v_max_y05": float(v[m, :].max()),
            "p_min_y05": float(p[m, :].min()),
            "p_max_y05": float(p[m, :].max())}


def g1() -> dict:
    from diffnet_tpu.data.flow import NSLDCDataset
    from diffnet_tpu.pde.flow import NavierStokes, ldc_bcs
    from diffnet_tpu.train import ns_newton_solve

    n = G1_GRID
    ds = NSLDCDataset(domain_sizes=(n, n), Re=G1_RE)
    ds.n_samples = 1
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    m = NavierStokes(None, ds, domain_size=n, batch_size=1, Re=G1_RE,
                     u_bc=u_bc, v_bc=v_bc, p_bc=p_bc)
    t0 = time.perf_counter()
    (u, v, p), info = ns_newton_solve(m, newton_iters=G1_NEWTON_ITERS)
    return {"figure": "G1", "grid": n, "Re": G1_RE,
            "final_F": float(info["residual_history"][-1]),
            "newton_steps": int(info["newton_iters"]),
            "residual_history": [float(r) for r in info["residual_history"]],
            **midline_figures(np.asarray(u), np.asarray(v), np.asarray(p)),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    print(json.dumps(g1()), flush=True)
