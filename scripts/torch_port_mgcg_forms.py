#!/usr/bin/env python3
"""Where the MG-CG figure of ``poisson_mms_2d --optimizer mg-cg`` comes
from, in both packages: the rel L2 error of the MMS solve after a given
number of CG iterations, for the residual's two forms, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_port_mgcg_forms.py 129 513 \
        --iters 10,20,160

Each line: the grid, the form (``unfused``: the module's einsum residual,
which the JAX CLI runs; ``k1``: the stiffness kernel's, ``fused_kernels=
True``, the JAX Pallas kernel interpreted and the port's plain version of
K1), the iteration cap, both packages' rel L2 and the largest difference
of their fields. Both build the problem as the CLIs do (the V-cycle from
unfused levels, tol 1e-10).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def _exact(x, y):
    return np.sin(math.pi * x) * np.sin(math.pi * y)


def _forcing(x, y):
    return 2 * math.pi**2 * np.sin(math.pi * x) * np.sin(math.pi * y)


def jax_module(n, fused=False, zero=False):
    from diffnet_tpu.data.single_instances import RectangleManufactured
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import Poisson2D

    ds = RectangleManufactured(domain_size=n)
    ds.n_samples = 1
    net = DirectField((n, n), **({"init": np.zeros((n, n))} if zero else {}))
    return Poisson2D(net, ds, domain_size=n, batch_size=1, fem_basis_deg=1,
                     loss_type="resmin", exact_solution=_exact,
                     forcing=_forcing, mms_dirichlet=True,
                     fused_kernels=fused)


def rel_l2(module, u) -> float:
    e, _, ref = module.calc_l2_err(u)
    return float(e / ref)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sizes", nargs="+", type=int)
    p.add_argument("--iters", default="10,20,160")
    args = p.parse_args()

    from functools import partial

    from jax.experimental import pallas as pl

    from diffnet_tpu.train import module_linear_solve as jsolve
    from diffnet_tpu.train import multigrid_preconditioner as jmg
    from diffnet_tpu_torch.examples.poisson_mms_2d import mms_module
    from diffnet_tpu_torch.train import module_linear_solve as psolve
    from diffnet_tpu_torch.train import multigrid_preconditioner as pmg

    pl.pallas_call = partial(pl.pallas_call, interpret=True)
    for n in args.sizes:
        jM, _ = jmg(jax_module, n)
        pM, _ = pmg(lambda m: mms_module(m, 1, "resmin", init=False), n,
                    device="cpu")
        for form in ("unfused", "k1"):
            fused = form == "k1"
            jm = jax_module(n, fused, zero=True)
            pm = mms_module(n, 1, "resmin", fused)
            for k in (int(v) for v in args.iters.split(",")):
                with contextlib.redirect_stdout(io.StringIO()):
                    uj, _ = jsolve(jm, tol=1e-10, M=jM, maxiter=k)
                    up, _ = psolve(pm, tol=1e-10, M=pM, maxiter=k,
                                   device="cpu")
                    uj = np.asarray(uj)
                    row = {"n": n, "form": form, "iters": k,
                           "jax": rel_l2(jm, uj),
                           "port": rel_l2(pm, torch.as_tensor(up)),
                           "max_field_diff": float(np.abs(uj - up).max())}
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
