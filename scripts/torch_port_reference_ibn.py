#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's IBN check is held to.

Runs the JAX package on the CPU on chip_smoke.py's slice H, the IBN
flagship (reference IBN_2D.py): 1,024 synthetic ellipse clouds of 120
points on a 32^2 grid, batches of ``BATCH`` shuffled, the winding-number
chi fed to ``AE(dims=8, n_downsample=2)`` started from the weights
``seeded_params`` draws from ``INIT_SEED`` (the port loads the same tree
through ``params_from_jax``), the gpw-weighted Ritz energy, Adam at 3e-4
with the learning rate divided by 10 at each of ``MILESTONES`` (epochs),
for ``EPOCHS`` epochs. Then 8 held-out clouds (seed 1), each scored
against the direct Krylov solve of its own immersed problem
(``module_linear_solve`` through ``residual_for_field``): the relative L2
of the network's field on the free nodes (chi < 0.5) and the energy gap
(E_net - E*) / E*, after every epoch and before the first. It prints one
JSON line: the epoch losses, the held-out figures by epoch, the final
per-geometry and mean figures, and the seconds.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_ibn.py
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_ibn.py \
        --batch 128 --epochs 40 --milestones 10,15,30   # another schedule

chip_smoke.py keeps its own copy of the configuration and of the scoring
(it imports no JAX); the two must stay the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np

from torch_port_reference_ibn3d import seeded_params, shape_tree

GRID, N_TRAIN, N_POINTS, BATCH = 32, 1024, 120, 64
LR, MILESTONES, EPOCHS = 3e-4, (10, 15, 30), 40
INIT_SEED = 0
N_HELDOUT, HELDOUT_SEED = 8, 1


def heldout_figures(rel_l2: list[float], gaps: list[float]) -> dict:
    return {"heldout_rel_l2": rel_l2, "heldout_energy_gap": gaps,
            "heldout_rel_l2_mean": float(np.mean(rel_l2)),
            "heldout_energy_gap_mean": float(np.mean(gaps))}


def slice_h(batch_size=BATCH, epochs=EPOCHS, milestones=MILESTONES) -> dict:
    import jax
    import jax.numpy as jnp

    from diffnet_tpu.data import NumpyLoader
    from diffnet_tpu.data.parametric import SyntheticPointClouds
    from diffnet_tpu.models import AE
    from diffnet_tpu.pde import IBNPoisson2D
    from diffnet_tpu.train import Callback, Trainer
    from diffnet_tpu.train.linear import module_linear_solve

    t0 = time.perf_counter()
    ds = SyntheticPointClouds(n_samples=N_TRAIN, n_points=N_POINTS,
                              domain_size=GRID, seed=0)
    loader = NumpyLoader(ds, batch_size=batch_size, shuffle=True)
    module = IBNPoisson2D(AE(out_channels=1, dims=8, n_downsample=2),
                          domain_size=GRID, batch_size=batch_size,
                          learning_rate=LR)

    held = SyntheticPointClouds(n_samples=N_HELDOUT, n_points=N_POINTS,
                                domain_size=GRID, seed=HELDOUT_SEED)
    cases = [tuple(jnp.asarray(a)[None] for a in held[i])
             for i in range(N_HELDOUT)]
    refs = []   # the direct solves, made at the first scoring

    def score(params) -> dict:
        rel_l2, gaps = [], []
        for i, batch in enumerate(cases):
            u_net, inputs, forcing = module.forward(params, batch)
            u_net = np.asarray(module.apply_bcs(u_net, inputs))[0]
            if len(refs) <= i:
                u_ref, _ = module_linear_solve(
                    module, inputs_tensor=np.asarray(inputs)[0],
                    forcing_tensor=np.asarray(forcing)[0], tol=1e-8)
                refs.append(np.asarray(u_ref))
            u_ref = refs[i]
            free = np.asarray(inputs)[0, ..., 1] < 0.5
            rel_l2.append(float(np.linalg.norm((u_net - u_ref)[free])
                                / np.linalg.norm(u_ref[free])))
            e_net, e_ref = (float(module.loss(jnp.asarray(v)[None], inputs,
                                              forcing))
                            for v in (u_net, u_ref))
            gaps.append((e_net - e_ref) / e_ref)
        return heldout_figures(rel_l2, gaps)

    class Record(Callback):
        def __init__(self):
            self.losses, self.heldout = [], []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])
            self.heldout.append(score(state.params)["heldout_rel_l2_mean"])

    shapes = jax.eval_shape(module.init_params, jax.random.key(0),
                            next(iter(loader)))["params"]
    params0 = {"params": jax.tree.map(jnp.asarray, seeded_params(
        shape_tree(shapes), INIT_SEED))}
    init = score(params0)   # before fit, which donates its buffers
    rec = Record()
    t1 = time.perf_counter()
    state = Trainer(max_epochs=epochs, optimizer="adam", learning_rate=LR,
                    lr_milestones=list(milestones) or None,
                    callbacks=[rec]).fit(module, loader, params=params0)
    train_s = time.perf_counter() - t1
    return {"figure": "H", "grid": GRID, "batch": batch_size,
            "epochs": epochs, "milestones": list(milestones),
            "init_seed": INIT_SEED, "steps": epochs * len(loader),
            "losses": rec.losses, "first_epoch_loss": rec.losses[0],
            "last_epoch_loss": rec.losses[-1],
            "heldout_rel_l2_by_epoch": rec.heldout, **score(state.params),
            "untrained_heldout_rel_l2_mean": init["heldout_rel_l2_mean"],
            "train_seconds": train_s,
            "seconds": time.perf_counter() - t0, "jax": jax.__version__}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--milestones", default=",".join(map(str, MILESTONES)),
                   help="comma-separated epochs; empty for none")
    a = p.parse_args()
    ms = tuple(int(v) for v in a.milestones.split(",") if v)
    print(json.dumps(slice_h(a.batch, a.epochs, ms)), flush=True)
