#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's round-robin check is
held to.

Runs the JAX package on the CPU on chip_smoke.py's slice K, the reference's
e1_ns_ldc_resmin setup: the Re-100 lid-driven cavity on 64^2 nodes
(``NSLDCDataset``, the regularised lid of ``ldc_bcs``), a three-field
``DirectField`` from zeros, ``NavierStokes(loss_norm="squared")``, and
``Trainer(round_robin=True)``: one optimizer per field residual, each
scoped to its own field (``objective_param_mask``), the objective rotating
once a batch (one batch an epoch). Adam at ``LR`` with the rate times 0.1
after ``MILESTONE`` updates of each objective, then at epoch ``SWITCH``
``OptimizerSwitch`` swaps in ``[LBFGS(u), LBFGS(v), Adam(p)]`` (LBFGS x 10
iterations a step) for ``EPOCHS - SWITCH`` more epochs.

Why these numbers: objective 0 (the u-momentum residual, 98% of the first
total) falls 11.7x under Adam by the switch; the block scheme plateaus
there (each field only lowers its own residual, so the pressure never
answers the momentum rows). Three LBFGS steps of each velocity field
follow. chip_smoke.py splits the run at epoch EPOCHS / 2 = 154 (a
rotation counter that is no multiple of three) for its exact-resume check.

Figures, at the switch and at the end: each objective's loss at the
parameters, the midline extrema of u and v and the pressure range on
y = 0.5 (as chip_smoke.py's ``midline_figures``), the lid error. One JSON
line.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_rr.py

(~1 minute on 8 CPU cores.) The JAX module runs its XLA residual; on the
CPU its Pallas kernel would run interpreted and computes the same one.
chip_smoke.py keeps its own copy of the configuration (it imports no JAX).
The Adam phase differs between the packages in rounding only; the LBFGS
steps do not agree step by step (optax's zoom line search against torch's
strong Wolfe search), so the end figures are compared more loosely.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

GRID, RE = 64, 100.0
LR, MILESTONE, SWITCH, EPOCHS, LBFGS_ITERS = 3e-2, 40, 300, 308, 10
SWITCH_TO = ["lbfgs", "lbfgs", "adam"]


def midline_figures(u, v, p) -> dict:
    m = u.shape[0] // 2
    return {"u_min_x05": float(u[:, m].min()),
            "v_min_y05": float(v[m, :].min()),
            "v_max_y05": float(v[m, :].max()),
            "p_min_y05": float(p[m, :].min()),
            "p_max_y05": float(p[m, :].max())}


def lid_err(u: np.ndarray) -> float:
    x = np.linspace(0.0, 1.0, u.shape[1])
    return float(np.abs(u[-1] - (1.0 - 16.0 * (x - 0.5) ** 4)).max())


def slice_k() -> dict:
    import jax
    import jax.numpy as jnp

    from diffnet_tpu.data.flow import NSLDCDataset
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import NavierStokes, ldc_bcs
    from diffnet_tpu.train import Callback, Trainer
    from diffnet_tpu.train.trainer import OptimizerSwitch

    n = GRID
    ds = NSLDCDataset(domain_sizes=(n, n), Re=RE)
    ds.n_samples = 1
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    module = NavierStokes(
        DirectField((n, n), init=np.zeros((n, n)), n_fields=3), ds,
        domain_size=n, batch_size=1, Re=RE, u_bc=u_bc, v_bc=v_bc,
        p_bc=p_bc, loss_norm="squared")
    batch = tuple(jnp.asarray(a)[None] for a in ds[0])

    def figures(params) -> dict:
        u, v, p = (np.asarray(a)[0] for a in module.apply_bcs(
            module.network.apply(params, batch[0]), batch[0]))
        return {"objective_losses": [
                    float(module.objective_loss(i, params, batch))
                    for i in range(3)],
                **midline_figures(u, v, p), "lid_max_err": lid_err(u)}

    class Record(Callback):
        def __init__(self):
            self.losses, self.at_switch = [], None

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])
            if epoch + 1 == SWITCH:
                self.at_switch = figures(state.params)

    t0 = time.perf_counter()
    start = figures(module.network.init(None))
    rec = Record()
    trainer = Trainer(max_epochs=EPOCHS, optimizer="adam", learning_rate=LR,
                      lr_milestones=[MILESTONE], round_robin=True,
                      lbfgs_max_iter=LBFGS_ITERS,
                      callbacks=[rec, OptimizerSwitch(SWITCH, SWITCH_TO)])
    state = trainer.fit(module)
    return {"figure": "K", "grid": GRID, "Re": RE, "lr": LR,
            "milestone": MILESTONE, "switch": SWITCH, "epochs": EPOCHS,
            "switch_to": SWITCH_TO, "lbfgs_max_iter": LBFGS_ITERS,
            "start": start, "at_switch": rec.at_switch,
            "end": figures(state.params),
            "obj0_drop_at_switch": (start["objective_losses"][0]
                                    / rec.at_switch["objective_losses"][0]),
            "epoch_losses_first": rec.losses[:3],
            "epoch_losses_last": rec.losses[-6:],
            "seconds": time.perf_counter() - t0, "jax": jax.__version__}


if __name__ == "__main__":
    print(json.dumps(slice_k()), flush=True)
