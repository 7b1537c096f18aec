#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's slice M
(chip_smoke.py) is held to.

Runs the JAX package on the CPU on each case of slice M:

  M1 the FSDT plate (examples/more_physics.py fsdt): ``ElasticFSDTDataset``
     at its own 64^2, ``ElasticFSDT(loss_norm="squared")`` on a three-field
     ``DirectField`` from zeros, LBFGS x 10 for the example's 100 epochs;
     the rel L2 of w on the free nodes against the float64 direct solve of
     the same discrete operator (the residual is affine: 27 coloured
     probes give its sparse Jacobian, as tests/test_physics_misc.py's
     dense solve at 9^2), the largest |w| on the clamped walls and the
     centre deflection beside the direct solve's;
  M2 the immersed single instances ``RectangleIM``, ``RectangleIMBack``,
     ``CircleIMBack`` and ``LShaped`` at their default 64^2: ``Poisson2D``'s
     energy (channel 0, the domain mask, is nu) on a ``DirectField`` from
     zeros and from three rounding-level starts (IM_START_SCALES), LBFGS x
     10 for IM_EPOCHS epochs, through both of the JAX package's float32
     paths of that loss (XLA, and its K3 kernel in interpret mode); each
     fit's rel L2 on the free nodes (not Dirichlet, and a nonzero row: nu =
     0 leaves rows empty outside the object) against the float64 direct
     solve of its discrete system, and each path's median over the starts.
     JAX's loss has settled by epoch 15 in every case (to its float32
     rounding); 50 epochs leave every fit on float32's floor, where the
     figure spreads over the starts and the paths (2e-7 to 3e-6).
     ``ImageIMBack`` and ``Disk`` read an image through PIL, which the
     card's machine lacks: the CPU tests hold them
     (tests/test_torch_misc_port.py), not this script;
  M3 SIMP topology optimisation: ``TopOpt2D.optimize`` on
     tests/test_physics_misc.py's problem (32^2, the sink on the first row,
     unit forcing, target_vf 0.4, compliance_form "variational", 80 outer
     iterations): the five criteria of that test with their figures, the
     first outer iteration's compliance (the state solve before any design
     step) and the last.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_topopt.py \
        [CASE ...] [--explore EPOCHS,...]

(CASE: fsdt, immersed, topopt, all by default; ~4 minutes on 8 CPU
cores, most of it K3 in interpret mode.) ``--explore`` prints M1's and
M2's figures after each listed epoch count of one longer fit instead, to
choose the budgets. Prints one JSON line per case, then one with all of
them and the seconds. The cases' sizes, budgets, problem, direct solves
and scorers are those of scripts/torch_port_reference_topopt_cases.py,
which chip_smoke.py imports too.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_port_reference_topopt_cases import (  # noqa: E402
    FIGURES, FSDT_EPOCHS, FSDT_GRID, IM_CASES, IM_EPOCHS, IM_GRID,
    IM_START_SCALES, LBFGS_ITERS, TOPOPT_GRID, TOPOPT_OUTER, TOPOPT_VF,
    direct_solve, im_start, rel_l2_free, topopt_figures, topopt_problem)


def _x64_resid(fn, inputs, forcing):
    """A float64 numpy residual ``z [F, n, n] -> [F, n, n]`` of the JAX
    module function ``fn(pred_fields, inputs, forcing)``."""
    import jax
    import jax.numpy as jnp

    def resid(z):
        with jax.enable_x64(True):
            fields = tuple(jnp.asarray(a)[None] for a in z)
            R = fn(fields, jnp.asarray(inputs, jnp.float64)[None],
                   jnp.asarray(forcing, jnp.float64)[None])
            return np.stack([np.asarray(r)[0] for r in R])
    return resid


class _Checkpoints:
    """Calls ``score(params)`` after each epoch count in `at`."""

    def __init__(self, at, score):
        self.at, self.score, self.out = set(at), score, {}

    def on_train_start(self, trainer, module, state):
        pass

    def on_train_end(self, trainer, module, state):
        pass

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        if epoch + 1 in self.at:
            self.out[epoch + 1] = {"loss": float(metrics["loss"]),
                                   **self.score(state.params)}


def _fit(m, epochs, explore):
    from diffnet_tpu.train import Trainer

    cbs = [explore] if explore is not None else []
    return Trainer(max_epochs=epochs, optimizer="lbfgs",
                   lbfgs_max_iter=LBFGS_ITERS, callbacks=cbs).fit(m)


def case_fsdt(explore_at=None) -> dict:
    import jax.numpy as jnp

    from diffnet_tpu.data.geometry_datasets import ElasticFSDTDataset
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import ElasticFSDT

    n = FSDT_GRID
    ds = ElasticFSDTDataset(domain_size=n)
    ds.n_samples = 1
    m = ElasticFSDT(DirectField((n, n), init=np.zeros((n, n)), n_fields=3),
                    ds, domain_size=n, batch_size=1, loss_norm="squared")
    inputs, forcing = ds[0]
    z, free = direct_solve(_x64_resid(m.calc_residuals, inputs, forcing), 3,
                           (n, n))
    walls = inputs[..., 3] > 0.5
    batch = jnp.asarray(inputs)[None]

    def score(params):
        w = np.asarray(m.apply_bcs(m.network.apply(params, batch),
                                   batch)[0])[0]
        return {"rel_l2_w_free": rel_l2_free(w, z[0], free[0]),
                "walls_max_abs_w": float(np.abs(w[walls]).max()),
                "centre_w": float(w[n // 2, n // 2])}

    explore = (_Checkpoints(explore_at, score) if explore_at
               else _Checkpoints((1, FSDT_EPOCHS), lambda p: {}))
    st = _fit(m, max(explore_at) if explore_at else FSDT_EPOCHS, explore)
    if explore_at is not None:
        return {"fsdt_explore": explore.out}
    return {"grid": [n, n], "epochs": FSDT_EPOCHS, **score(st.params),
            "first_loss": explore.out[1]["loss"],
            "last_loss": explore.out[FSDT_EPOCHS]["loss"],
            "centre_w_direct": float(z[0, n // 2, n // 2]),
            "free_nodes_w": int(free[0].sum())}


def case_immersed(explore_at=None) -> dict:
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from diffnet_tpu.data import single_instances as si
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import Poisson2D

    n = IM_GRID
    out = {}
    interpret = functools.partial(pl.pallas_call, interpret=True)
    for name in IM_CASES:
        ds = getattr(si, name)(domain_size=n)
        ds.n_samples = 1
        inputs, forcing = ds[0]
        m0 = Poisson2D(None, ds, domain_size=n, batch_size=1)
        z, free = direct_solve(_x64_resid(
            lambda f, i, fo: (m0.residual_for_field(f[0], i, fo),),
            inputs, forcing), 1, (n, n))
        batch = jnp.asarray(inputs)[None]
        case = {"free_nodes": int(free.sum())}
        for path, fused in (("xla", False), ("k3", True)):
            figs = []
            for scale in IM_START_SCALES:
                m = Poisson2D(DirectField((n, n), init=im_start(n, scale)),
                              ds, domain_size=n, batch_size=1,
                              fused_kernels=fused)

                def score(params, m=m):
                    u = np.asarray(m.apply_bcs(m.network.apply(params, batch),
                                               batch))[0]
                    return {"rel_l2_free": rel_l2_free(u, z[0], free[0])}

                explore = (None if explore_at is None
                           else _Checkpoints(explore_at, score))
                orig = pl.pallas_call
                pl.pallas_call = interpret   # K3 on the CPU
                try:
                    st = _fit(m, max(explore_at) if explore_at
                              else IM_EPOCHS, explore)
                finally:
                    pl.pallas_call = orig
                figs.append(explore.out if explore is not None
                            else score(st.params)["rel_l2_free"])
            case[path] = figs
            if explore_at is None:
                case[f"{path}_median"] = float(np.median(figs))
        out[name] = case
        if explore_at is None:
            print(json.dumps({name: case}), flush=True)
    if explore_at is not None:
        return {"immersed_explore": out}
    return {"grid": [n, n], "epochs": IM_EPOCHS,
            "start_scales": list(IM_START_SCALES), **out}


def case_topopt() -> dict:
    import jax.numpy as jnp

    from diffnet_tpu.pde import TopOpt2D

    n = TOPOPT_GRID
    inputs, forcing = topopt_problem(n)

    class JointField:
        def init(self, rng, sample=None):
            return {"u": jnp.zeros((n, n)), "rho": jnp.zeros((n, n))}

        def apply(self, params, inp=None):
            b = 1 if inp is None else inp.shape[0]
            return (jnp.broadcast_to(params["u"][None], (b, n, n)),
                    jnp.broadcast_to(params["rho"][None], (b, n, n)))

    m = TopOpt2D(JointField(), None, domain_size=n, batch_size=1,
                 target_vf=TOPOPT_VF, compliance_form="variational")
    t0 = time.perf_counter()
    rho_raw, u, hist = m.optimize(inputs, forcing, n_outer=TOPOPT_OUTER)
    seconds = time.perf_counter() - t0
    rho = np.asarray(m.project_density(rho_raw))
    return {"grid": [n, n], "n_outer": TOPOPT_OUTER,
            **topopt_figures(rho, hist), "history": [float(h) for h in hist],
            "seconds": seconds}


CASES = {"fsdt": case_fsdt, "immersed": case_immersed, "topopt": case_topopt}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("cases", nargs="*", choices=list(CASES) + [[]])
    p.add_argument("--explore", default=None,
                   help="comma-separated epoch counts (M1 and M2)")
    args = p.parse_args()
    names = args.cases or list(CASES)
    explore_at = ([int(e) for e in args.explore.split(",")]
                  if args.explore else None)
    t0 = time.perf_counter()
    out = {}
    for name in names:
        t = time.perf_counter()
        if explore_at is not None and name != "topopt":
            res = CASES[name](explore_at)
        else:
            res = CASES[name]()
        res["case_seconds"] = time.perf_counter() - t
        print(json.dumps({name: res}), flush=True)
        out[name] = res
    assert set(out) <= set(FIGURES)
    print(json.dumps({"figures": out,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
