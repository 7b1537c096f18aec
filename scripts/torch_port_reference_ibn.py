#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's IBN check is held to.

Runs the JAX package on the CPU on chip_smoke.py's slice H, the IBN
flagship (reference IBN_2D.py): 1,024 synthetic ellipse clouds of 120
points on a 32^2 grid, batches of 512 shuffled, the winding-number chi fed
to ``AE(dims=8, n_downsample=2)``, the gpw-weighted Ritz energy,
Adam at 3e-4 with the learning rate divided by 10 after epochs 10, 15 and
30, for ``EPOCHS`` epochs. Then 8 held-out clouds (seed 1), each scored
against the direct Krylov solve of its own immersed problem
(``module_linear_solve`` through ``residual_for_field``): the relative L2
of the network's field on the free nodes (chi < 0.5) and the energy gap
(E_net - E*) / E*. It prints one JSON line: the first and last epoch
losses, the per-geometry and mean figures, and the seconds.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_ibn.py

chip_smoke.py keeps its own copy of the configuration and of the scoring
(it imports no JAX); the two must stay the same. Its network draws other
initial weights from the same initializer (flax's lecun_normal), so the
figures are compared within a factor, not digit for digit.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

GRID, N_TRAIN, N_POINTS, BATCH = 32, 1024, 120, 512
LR, MILESTONES, EPOCHS = 3e-4, (10, 15, 30), 40
N_HELDOUT, HELDOUT_SEED = 8, 1


def heldout_figures(rel_l2: list[float], gaps: list[float]) -> dict:
    return {"heldout_rel_l2": rel_l2, "heldout_energy_gap": gaps,
            "heldout_rel_l2_mean": float(np.mean(rel_l2)),
            "heldout_energy_gap_mean": float(np.mean(gaps))}


def slice_h() -> dict:
    import jax
    import jax.numpy as jnp

    from diffnet_tpu.data import NumpyLoader
    from diffnet_tpu.data.parametric import SyntheticPointClouds
    from diffnet_tpu.models import AE
    from diffnet_tpu.pde import IBNPoisson2D
    from diffnet_tpu.train import Callback, Trainer
    from diffnet_tpu.train.linear import module_linear_solve

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])

    t0 = time.perf_counter()
    ds = SyntheticPointClouds(n_samples=N_TRAIN, n_points=N_POINTS,
                              domain_size=GRID, seed=0)
    loader = NumpyLoader(ds, batch_size=BATCH, shuffle=True)
    module = IBNPoisson2D(AE(out_channels=1, dims=8, n_downsample=2),
                          domain_size=GRID, batch_size=BATCH,
                          learning_rate=LR)
    rec = Losses()
    state = Trainer(max_epochs=EPOCHS, optimizer="adam", learning_rate=LR,
                    lr_milestones=MILESTONES, callbacks=[rec]).fit(
                        module, loader)
    train_s = time.perf_counter() - t0

    held = SyntheticPointClouds(n_samples=N_HELDOUT, n_points=N_POINTS,
                                domain_size=GRID, seed=HELDOUT_SEED)
    rel_l2, gaps = [], []
    for i in range(N_HELDOUT):
        batch = tuple(jnp.asarray(a)[None] for a in held[i])
        u_net, inputs, forcing = module.forward(state.params, batch)
        u_net = np.asarray(module.apply_bcs(u_net, inputs))[0]
        u_ref, _ = module_linear_solve(
            module, inputs_tensor=np.asarray(inputs)[0],
            forcing_tensor=np.asarray(forcing)[0], tol=1e-8)
        u_ref = np.asarray(u_ref)
        free = np.asarray(inputs)[0, ..., 1] < 0.5
        rel_l2.append(float(np.linalg.norm((u_net - u_ref)[free])
                            / np.linalg.norm(u_ref[free])))
        e_net = float(module.loss(jnp.asarray(u_net)[None], inputs, forcing))
        e_ref = float(module.loss(jnp.asarray(u_ref)[None], inputs, forcing))
        gaps.append((e_net - e_ref) / e_ref)
    return {"figure": "H", "grid": GRID, "batch": BATCH, "epochs": EPOCHS,
            "steps": EPOCHS * len(loader), "first_epoch_loss": rec.losses[0],
            "last_epoch_loss": rec.losses[-1],
            **heldout_figures(rel_l2, gaps), "train_seconds": train_s,
            "seconds": time.perf_counter() - t0, "jax": jax.__version__}


if __name__ == "__main__":
    print(json.dumps(slice_h()), flush=True)
