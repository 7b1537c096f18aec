#!/usr/bin/env python3
"""Run slice I of chip_smoke.py (the 3D IBN at 32^3, batch 8,
UNet3D(base_filters=16), from the JAX reference's initial weights) several
times on one CUDA card, to read the run-to-run spread of its held-out rel
L2 beside the limit chip_smoke.py holds it to (I_REL_L2_FACTOR x the JAX
package's figure). The runs start from the same weights and see the same
batches; cuDNN's backward convolutions sum in an order that can vary from
run to run, and 288 Adam steps amplify that rounding.

    python3 scripts/slice_i_repeats.py [--runs 4]

It prints the card's name and power limit, each run's held-out figures as
a JSON line, and a last JSON line with the readings, their min, mean and
max, and the limit. A run over the limit is reported, not raised.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    smi = cs.phase_device(dev)
    cs.phase_build()
    rows = []
    cs.emit = rows.append          # slice_i's own line, kept, not printed
    limit = cs.I_REL_L2_FACTOR * cs.JAX_I["heldout_rel_l2_mean"]
    readings = []
    for run in range(args.runs):
        try:
            cs.slice_i(dev, smi)
            failed = None
        except RuntimeError as e:   # the rel L2 check, after its line
            failed = str(e)
        row = rows[-1]
        readings.append(row["heldout_rel_l2_mean"])
        print(json.dumps({
            "run": run, "failed": failed,
            **{k: row[k] for k in (
                "heldout_rel_l2", "heldout_rel_l2_mean",
                "heldout_energy_gap_mean", "first_epoch_loss",
                "last_epoch_loss", "cg_iters", "launches")}}), flush=True)
    print(json.dumps({
        "nvidia_smi": smi, "init_seed": cs.I_INIT_SEED,
        "heldout_rel_l2_means": readings, "min": min(readings),
        "mean": float(np.mean(readings)), "max": max(readings),
        "jax": cs.JAX_I["heldout_rel_l2_mean"], "limit": limit}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
