#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's 3D IBN check is held to.

Runs the JAX package on the CPU on chip_smoke.py's slice I, the 3D IBN
(reference IBN_3D.py): ``TRAIN`` synthetic bar-lattice topologies
(``synthesize_topology_3d``, seeds 0 ...) on 32^3 nodes through
``TopoDataset3D``, batches of 8 shuffled, ``UNet3D(out_channels=1,
base_filters=16)``, the gpw-weighted Ritz energy of ``IBNPoisson3D`` (u = 1
on the object, 0 on the box), Adam at 1e-3 (examples/ibn_3d.py) for
``EPOCHS`` epochs. Then ``HELDOUT`` held-out topologies (seeds
``HELDOUT_SEEDS``), each scored against the direct Krylov solve of its own
problem: ``module_linear_solve`` (CG, tol ``SOLVE_TOL``) on a ``Poisson3D``
resmin module over the same (domain, chi, bc2) inputs, with bc1 = 1 and
bc2 = 0. The tolerance is 1e-6, not 1e-8: in float32 CG's recursive
residual stalls near 1.4e-7 at 32^3 and would run all its 1,810
iterations; it reaches 1e-6 in ~70, where the true relative residual is
already at its float32 floor (~7e-5), so the reference field is the same.
The figures: the relative L2 of the network's field on the free nodes
(chi < 0.5 and off the box) and the energy gap (E_net - E*) / E* under
the IBN energy. The same held-out figures are printed for the untrained
network. It prints one JSON line.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_ibn3d.py

(~13 minutes on 8 CPU cores.) The JAX package's direct solve runs its XLA
operator (``fused_kernels=False``): on the CPU its Pallas kernel would run
interpreted, and the two compute the same residual. chip_smoke.py keeps
its own copy of the configuration and of the scoring (it imports no JAX);
the two must stay the same. Both start from the same initial weights:
``seeded_params`` draws UNet3D's flax tree with numpy from ``INIT_SEED``
by flax's initializers, as the port's ``interop.seeded_params`` does
(tests/test_torch_ibn3d.py holds the two draws equal), and the port loads
it through ``params_from_jax``. Neither package uses dropout in training
(the network is applied with ``train=False``), so the runs differ only in
rounding: the figures are compared within a factor, not digit for digit.
"""

from __future__ import annotations

import json
import os
import sys
import time
import zlib
from typing import Mapping

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

GRID, TRAIN, BATCH, BASE_FILTERS = 32, 64, 8, 16
LR, EPOCHS = 1e-3, 36
INIT_SEED = 0
HELDOUT_SEEDS = (1000, 1001, 1002, 1003)
SOLVE_TOL = 1e-6


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    x = rng.standard_normal(shape)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) > 2.0
    return x


def seeded_params(shapes: Mapping, seed: int, prefix: tuple = ()) -> dict:
    """A flax parameter tree of the given shapes (nested dicts of shape
    tuples, without the ``"params"`` root) drawn with numpy from `seed`:
    a ``kernel`` lecun_normal (a normal truncated at two standard
    deviations, variance 1 / fan_in over every axis but the last, or the
    last but one of a LocalConv2d kernel), a ``scale`` ones, anything else
    zeros; each leaf from its own stream keyed by `seed` and its path. A
    copy of the port's ``diffnet_tpu_torch.interop.seeded_params``."""
    tree = {}
    for k, v in shapes.items():
        path = prefix + (k,)
        if isinstance(v, Mapping):
            tree[k] = seeded_params(v, seed, path)
            continue
        shape = tuple(v)
        if k == "kernel":
            local = len(shape) == 4 and (
                not prefix or prefix[-1].startswith("LocalConv2d"))
            fan_in = shape[-2] if local else int(np.prod(shape[:-1]))
            rng = np.random.default_rng(
                [seed, zlib.crc32("/".join(path).encode())])
            a = _truncated_normal(rng, shape) * (
                np.sqrt(1.0 / fan_in) / 0.87962566103423978)
        else:
            a = np.full(shape, 1.0 if k == "scale" else 0.0)
        tree[k] = a.astype(np.float32)
    return tree


def shape_tree(tree: Mapping) -> dict:
    """Nested dicts of the leaves' shapes (from ``jax.eval_shape``)."""
    return {k: shape_tree(v) if isinstance(v, Mapping) else tuple(v.shape)
            for k, v in tree.items()}


def heldout_figures(rel_l2: list[float], gaps: list[float]) -> dict:
    return {"heldout_rel_l2": rel_l2, "heldout_energy_gap": gaps,
            "heldout_rel_l2_mean": float(np.mean(rel_l2)),
            "heldout_energy_gap_mean": float(np.mean(gaps))}


def slice_i() -> dict:
    import jax
    import jax.numpy as jnp

    from diffnet_tpu.data import NumpyLoader
    from diffnet_tpu.data.geometry_datasets import (TopoDataset3D,
                                                    synthesize_topology_3d)
    from diffnet_tpu.models import UNet3D
    from diffnet_tpu.pde import IBNPoisson3D, Poisson3D
    from diffnet_tpu.train import Callback, Trainer
    from diffnet_tpu.train.linear import module_linear_solve

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])

    t0 = time.perf_counter()
    ds = TopoDataset3D([synthesize_topology_3d(n=GRID, seed=s)
                        for s in range(TRAIN)], domain_size=GRID)
    loader = NumpyLoader(ds, batch_size=BATCH, shuffle=True)
    module = IBNPoisson3D(UNet3D(out_channels=1, base_filters=BASE_FILTERS),
                          domain_size=GRID, batch_size=BATCH,
                          learning_rate=LR)
    held = TopoDataset3D([synthesize_topology_3d(n=GRID, seed=s)
                          for s in HELDOUT_SEEDS], domain_size=GRID)
    solver = Poisson3D(domain_size=GRID, loss_type="resmin",
                       bc1_value=1.0, bc2_value=0.0)
    refs, relres = [], []
    for inputs, forcing in held:
        u_ref, _ = module_linear_solve(solver, inputs_tensor=inputs,
                                       forcing_tensor=forcing, tol=SOLVE_TOL)
        refs.append(np.asarray(u_ref))
        r0, r = (float(jnp.linalg.norm(solver.residual_for_field(
            jnp.asarray(v)[None], jnp.asarray(inputs)[None],
            jnp.asarray(forcing)[None]))) for v in (0 * refs[-1], refs[-1]))
        relres.append(r / r0)
    solve_s = time.perf_counter() - t0

    def score(params) -> dict:
        rel_l2, gaps = [], []
        for (inputs, forcing), u_ref in zip(held, refs):
            batch = (jnp.asarray(inputs)[None], jnp.asarray(forcing)[None])
            u_net, inp, frc = module.forward(params, batch)
            u_net = np.asarray(module.apply_bcs(u_net, inp))[0]
            free = (inputs[..., 1] < 0.5) & (inputs[..., 2] < 0.5)
            rel_l2.append(float(np.linalg.norm((u_net - u_ref)[free])
                                / np.linalg.norm(u_ref[free])))
            e_net, e_ref = (float(module.loss(jnp.asarray(v)[None], inp, frc))
                            for v in (u_net, u_ref))
            gaps.append((e_net - e_ref) / e_ref)
        return heldout_figures(rel_l2, gaps)

    shapes = jax.eval_shape(module.init_params, jax.random.key(0),
                            next(iter(loader)))["params"]
    params0 = {"params": jax.tree.map(jnp.asarray, seeded_params(
        shape_tree(shapes), INIT_SEED))}
    init = score(params0)   # before fit, which donates its buffers
    rec = Losses()
    trainer = Trainer(max_epochs=EPOCHS, optimizer="adam", learning_rate=LR,
                      callbacks=[rec])
    t1 = time.perf_counter()
    state = trainer.fit(module, loader, params=params0)
    train_s = time.perf_counter() - t1
    return {"figure": "I", "grid": GRID, "batch": BATCH,
            "base_filters": BASE_FILTERS, "init_seed": INIT_SEED,
            "volumes": TRAIN, "epochs": EPOCHS,
            "steps": EPOCHS * len(loader), "losses": rec.losses,
            "first_epoch_loss": rec.losses[0],
            "last_epoch_loss": rec.losses[-1], **score(state.params),
            "untrained_heldout_rel_l2_mean": init["heldout_rel_l2_mean"],
            "solve_tol": SOLVE_TOL, "true_relres": relres,
            "solve_seconds": solve_s, "train_seconds": train_s,
            "seconds": time.perf_counter() - t0, "jax": jax.__version__}


if __name__ == "__main__":
    print(json.dumps(slice_i()), flush=True)
