"""The study cases that the PyTorch port's slice R (chip_smoke.py) and the
JAX package's reference run (scripts/torch_port_reference_studies.py)
both take: the convergence rows and grids, the precision study's sizes,
the channel case, and the per-h rate and midline cuts both sides compute.

numpy only (no JAX, no torch), so that both sides import this one copy.
"""

from __future__ import annotations

import math

import numpy as np

# R1: the --quick grids of the Poisson resmin rows of the convergence
# study, by the port's row key: (element degree, grids, through K1)
R1_ROWS = {"poisson-resmin-deg1": (1, (17, 33), True),
           "poisson-resmin-deg2": (2, (9, 17), False),
           "poisson-resmin-deg3": (3, (7, 13), False)}

# R2: the precision study's sections at the JAX script's sizes
R2_ACC_GRIDS = (128, 512)             # section 1, bs 2
R2_MMS_GRID, R2_MMS_STEPS = 64, 300   # section 2, LBFGS steps
R2_POLICIES = ("f32", "bf16-residual", "bf16-accum")
R2_ADAM_GRID, R2_ADAM_STEPS = 32, 6000   # section 2b
R2_TP_GRID, R2_TP_BATCH = 512, 8      # section 3

# R3: one channel solve of the flow-past-square validation
R3_CASE, R3_H = "ns10", 0.25
R3_RE, R3_LENGTHS = 10, (12.0, 6.0)
R3_NEWTON_CAP = 30

# the figures the reference run prints, one key each
FIGURES = ("r1_errs", "r1_rates", "r2_accuracy", "r2_solve", "r2_adam",
           "r3_newton_iters", "r3_final_F", "r3_cuts", "r3_u_max",
           "r3_grid")


def rates(grids, errs) -> list:
    """The convergence study's per-h rate: log(e_i / e_{i+1}) /
    log(h_i / h_{i+1}), h = 1 / (n - 1)."""
    return [math.log(errs[i] / errs[i + 1])
            / math.log((grids[i + 1] - 1) / (grids[i] - 1))
            for i in range(len(errs) - 1)]


def midline_cuts(u, v, p, h) -> dict:
    """The flow-past-square anchors' cuts of ``[ny, nx]`` fields: u and p
    along the channel's mid row, u and v along the column at x = 2.5."""
    u, v, p = (np.asarray(a, np.float64) for a in (u, v, p))
    jmid, i = u.shape[0] // 2, int(round(2.5 / h))
    return {"uX": u[jmid, :], "pX": p[jmid, :], "uY": u[:, i],
            "vY": v[:, i]}
