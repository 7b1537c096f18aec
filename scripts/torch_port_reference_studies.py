#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's study check
(chip_smoke.py's slice R) is held to.

Runs the JAX study scripts' own functions on the CPU, at the sizes of
scripts/torch_port_reference_studies_cases.py:

  R1 scripts/convergence_study.py's ``solve_poisson`` (resmin, 120 LBFGS
     epochs of 10 iterations from zeros) at the --quick grids of the deg-1,
     deg-2 and deg-3 rows, and the per-h rates;
  R2 scripts/precision_study.py: ``accuracy_vs_f32`` at 128^2 and 512^2,
     ``solve_mms`` at 64^2 (300 optax L-BFGS steps) under the three
     policies, ``solve_mms_adam`` at 32^2 (6,000 Adam steps) in float32
     and bf16;
  R3 scripts/fps_validation.py's ``solve_case`` for ns10 at h = 1/4 (49 x
     25 nodes, Newton 30 / tol 1e-6 / GMRES 80 / restart 20): the Newton
     iterations, the final |F|, the midline cuts (u and p on the mid row,
     u and v on the column at x = 2.5; float32 values) and max |u|.

Prints one JSON line per case, then one with all of them and the seconds.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_studies.py [CASE ...]

(CASE: r1, r2, r3, all by default; ~3 minutes on 8 CPU cores.)
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from torch_port_reference_studies_cases import (  # noqa: E402
    R1_ROWS, R2_ACC_GRIDS, R2_ADAM_GRID, R2_ADAM_STEPS, R2_MMS_GRID,
    R2_MMS_STEPS, R2_POLICIES, R3_CASE, R3_H, R3_LENGTHS, R3_RE,
    midline_cuts, rates)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    argv, sys.argv = sys.argv, [sys.argv[0]]   # the study's own CPU pin
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


def case_r1() -> dict:
    cs = _script("convergence_study")
    errs = {k: [cs.solve_poisson(n, deg, "resmin") for n in grids]
            for k, (deg, grids, _) in R1_ROWS.items()}
    return {"r1_errs": errs,
            "r1_rates": {k: rates(R1_ROWS[k][1], e)
                         for k, e in errs.items()}}


def case_r2() -> dict:
    import jax.numpy as jnp

    ps = _script("precision_study")
    return {"r2_accuracy": {n: ps.accuracy_vs_f32(n) for n in R2_ACC_GRIDS},
            "r2_solve": {p: ps.solve_mms(R2_MMS_GRID, p, steps=R2_MMS_STEPS)
                         for p in R2_POLICIES},
            "r2_adam": {jnp.dtype(dt).name: ps.solve_mms_adam(
                R2_ADAM_GRID, dt, steps=R2_ADAM_STEPS)
                for dt in (jnp.float32, jnp.bfloat16)}}


def case_r3() -> dict:
    from diffnet_tpu.data.flow import NSFPSChannelDataset
    from diffnet_tpu.pde.flow import NavierStokes
    from diffnet_tpu.train.linear import ns_newton_solve

    # fps_validation.solve_case's problem and solver settings; the
    # solver's info (which solve_case drops) gives the iterations and |F|
    fv = _script("fps_validation")
    Lx, Ly = R3_LENGTHS
    nx, ny = int(round(Lx / R3_H)) + 1, int(round(Ly / R3_H)) + 1
    y0 = (Ly - 1.0) / 2.0
    ds = NSFPSChannelDataset(domain_lengths=(Lx, Ly), domain_sizes=(nx, ny),
                             obstacle=((2.0, y0), (3.0, y0 + 1.0)), Re=R3_RE)
    m = NavierStokes(None, ds, domain_lengths=(Lx, Ly),
                     domain_sizes=(nx, ny), batch_size=1, Re=R3_RE,
                     u_bc=ds.u_bc, v_bc=ds.v_bc, p_bc=ds.p_bc,
                     pressure_gauge="dirichlet")
    (u, v, p), info = ns_newton_solve(m, newton_iters=30, tol=1e-6,
                                      gmres_iters=80, restart=20)
    u2, v2, p2, _, _ = fv.solve_case("ns", R3_RE, Lx, Ly, R3_H)
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in ((u, u2), (v, v2), (p, p2)))
    if not same:
        raise SystemExit("R3: solve_case and its solver settings part")
    cuts = midline_cuts(u, v, p, R3_H)
    return {"r3_newton_iters": int(info["newton_iters"]),
            "r3_final_F": float(info["residual_history"][-1]),
            "r3_cuts": {k: [float(np.float32(x)) for x in c]
                        for k, c in cuts.items()},
            "r3_u_max": float(np.abs(np.asarray(u)).max()),
            "r3_grid": [nx, ny]}


CASES = {"r1": case_r1, "r2": case_r2, "r3": case_r3}


def main() -> None:
    names = sys.argv[1:] or list(CASES)
    t0 = time.perf_counter()
    out = {}
    for name in names:
        t = time.perf_counter()
        fig = CASES[name]()
        print(json.dumps({"case": name, "s": time.perf_counter() - t,
                          **fig}), flush=True)
        out.update(fig)
    print(json.dumps({"jax_slice_R": out,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
