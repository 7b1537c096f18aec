#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's KL-sum UQ check is held to.

Runs the JAX package on the CPU on chip_smoke.py's slice J, the parametric
KL-sum uncertainty-quantification pipeline (examples/klsum_uq.py at the
reference's 64^2 width, BASELINE.md's KL-sum training configuration):

  * ``TRAIN`` Sobol KL coefficient samples (``sobol_coefficients(TRAIN, 6,
    seed=0)``) through ``KLSumStochastic`` on 64^2 nodes: nu = exp(KL sum),
    u = 1 on the left wall, 0 on the right, no forcing;
  * ``GoodNetwork(in_dim=64, out_dim=64, filters=16)`` on the (nu, bc1,
    bc2) channels, from the initial weights ``seeded_params`` draws with
    numpy from ``INIT_SEED`` (the port loads the same tree through
    ``params_from_jax``);
  * ``Poisson2D(loss_type="energy", bc1_value=1, bc2_value=0)``, batches of
    32 shuffled, Adam 3e-4, ``EPOCHS`` epochs through ``Trainer.fit``;
  * ``query_statistical`` over ``QUERY`` Sobol samples (seed 1): the UQ
    mean and standard deviation fields;
  * the first ``HELDOUT`` of those query instances solved directly: CG
    (``module_linear_solve``, tol ``SOLVE_TOL``) on a ``Poisson2D`` resmin
    module over the same inputs. 64 nodes a side is no 2^k + 1 grid, so the
    geometric-multigrid V-cycle does not apply.

Figures: the held-out relative L2 of the network's field on the free nodes
(off the two Dirichlet walls) against each direct solve, after every epoch
and untrained; the energy gap (E_net - E*) / E*; the relative L2 of the UQ
mean and standard deviation fields against the Monte-Carlo mean and
standard deviation of the direct solves. One JSON line.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_klsum.py

(~9 minutes on 8 CPU cores, ~110 s an epoch.) The JAX package's Poisson
module runs its XLA operators (``fused_kernels=False``): on the CPU its
Pallas kernels would run interpreted, and they compute the same loss.
chip_smoke.py keeps its own copy of the configuration and the scoring (it
imports no JAX); the two must stay the same. Both packages start from the
same weights and see the same batches, so their runs differ in rounding
only: the figures are compared within a factor.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from torch_port_reference_ibn3d import seeded_params, shape_tree

GRID, TRAIN, BATCH, FILTERS = 64, 4096, 32, 16
LR, EPOCHS, INIT_SEED = 3e-4, 3, 0
QUERY, QUERY_SEED, HELDOUT = 256, 1, 64
SOLVE_TOL = 1e-6


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def slice_j() -> dict:
    import jax
    import jax.numpy as jnp

    from diffnet_tpu.data import NumpyLoader
    from diffnet_tpu.data.gen_input import sobol_coefficients
    from diffnet_tpu.data.parametric import KLSumStochastic
    from diffnet_tpu.models import GoodNetwork
    from diffnet_tpu.pde import Poisson2D
    from diffnet_tpu.train import Callback, Trainer, query_statistical
    from diffnet_tpu.train.linear import module_linear_solve

    t0 = time.perf_counter()
    train = KLSumStochastic(sobol_coefficients(TRAIN, 6, seed=0),
                            domain_size=GRID)
    query = KLSumStochastic(sobol_coefficients(QUERY, 6, seed=QUERY_SEED),
                            domain_size=GRID)
    module = Poisson2D(GoodNetwork(in_dim=GRID, out_dim=GRID,
                                   filters=FILTERS), train,
                       domain_size=GRID, batch_size=BATCH,
                       learning_rate=LR, loss_type="energy",
                       bc1_value=1.0, bc2_value=0.0)
    solver = Poisson2D(domain_size=GRID, loss_type="resmin",
                       bc1_value=1.0, bc2_value=0.0)
    refs, relres = [], []
    for i in range(HELDOUT):
        inputs, forcing = query[i]
        u_ref, _ = module_linear_solve(solver, inputs_tensor=inputs,
                                       forcing_tensor=forcing, tol=SOLVE_TOL)
        refs.append(np.asarray(u_ref))
        r0, r = (float(jnp.linalg.norm(solver.residual_for_field(
            jnp.asarray(v)[None], jnp.asarray(inputs)[None],
            jnp.asarray(forcing)[None]))) for v in (0 * refs[-1], refs[-1]))
        relres.append(r / r0)
    refs = np.stack(refs)
    solve_s = time.perf_counter() - t0

    def score(params) -> dict:
        rel, gaps = [], []
        for i in range(HELDOUT):
            inputs, forcing = query[i]
            batch = (jnp.asarray(inputs)[None], jnp.asarray(forcing)[None])
            u_net, inp, frc = module.forward(params, batch)
            u_net = np.asarray(module.apply_bcs(u_net, inp))[0]
            free = (inputs[..., 1] < 0.5) & (inputs[..., 2] < 0.5)
            rel.append(float(np.linalg.norm((u_net - refs[i])[free])
                             / np.linalg.norm(refs[i][free])))
            e_net, e_ref = (float(module.loss(jnp.asarray(v)[None], inp,
                                              frc))
                            for v in (u_net, refs[i]))
            gaps.append((e_net - e_ref) / abs(e_ref))
        return {"heldout_rel_l2": rel, "heldout_energy_gap": gaps,
                "heldout_rel_l2_mean": float(np.mean(rel)),
                "heldout_energy_gap_mean": float(np.mean(gaps))}

    class Record(Callback):
        def __init__(self):
            self.losses, self.heldout = [], []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])
            self.heldout.append(score(state.params)["heldout_rel_l2_mean"])

    loader = NumpyLoader(train, batch_size=BATCH, shuffle=True)
    shapes = jax.eval_shape(module.init_params, jax.random.key(0),
                            next(iter(loader)))["params"]
    params0 = {"params": jax.tree.map(jnp.asarray, seeded_params(
        shape_tree(shapes), INIT_SEED))}
    init = score(params0)   # before fit, which donates its buffers
    rec = Record()
    trainer = Trainer(max_epochs=EPOCHS, optimizer="adam", learning_rate=LR,
                      callbacks=[rec])
    t1 = time.perf_counter()
    state = trainer.fit(module, NumpyLoader(train, batch_size=BATCH,
                                            shuffle=True), params=params0)
    train_s = time.perf_counter() - t1
    mean, sdev, _ = query_statistical(module, state.params, query,
                                      batch_size=BATCH)
    return {"figure": "J", "grid": GRID, "batch": BATCH,
            "filters": FILTERS, "init_seed": INIT_SEED, "samples": TRAIN,
            "epochs": EPOCHS, "steps": EPOCHS * len(loader),
            "losses": rec.losses, "first_epoch_loss": rec.losses[0],
            "last_epoch_loss": rec.losses[-1],
            "heldout_rel_l2_by_epoch": rec.heldout, **score(state.params),
            "untrained_heldout_rel_l2_mean": init["heldout_rel_l2_mean"],
            "uq_mean_rel_l2": rel_l2(np.asarray(mean), refs.mean(0)),
            "uq_sdev_rel_l2": rel_l2(np.asarray(sdev), refs.std(0)),
            "solve_tol": SOLVE_TOL, "true_relres_max": max(relres),
            "solve_seconds": solve_s, "train_seconds": train_s,
            "seconds": time.perf_counter() - t0, "jax": jax.__version__}


if __name__ == "__main__":
    print(json.dumps(slice_j()), flush=True)
