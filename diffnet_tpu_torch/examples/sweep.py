"""Multi-run sweep + statistics runner (port of ``examples/sweep.py``) —
the config-driven replacement for the reference's sed-editing shell loops
(examples/poisson/parametric/run-multiple.sh:17-19 sweeps a sample_size
by rewriting source lines; run-mean-sdev.sh re-walks version dirs to
aggregate). One command runs the sweep, writes versioned run dirs, and
produces an aggregate CSV + plot and cross-run mean/sdev artifacts.

    # the reference's KL-sum sample-size sweep (4096..65536 at full scale)
    python -m diffnet_tpu_torch.examples.sweep --physics klsum \
        --param n_train --values 128,256,512 --max-epochs 5

    # grid-convergence sweep on the Poisson MMS workload
    python -m diffnet_tpu_torch.examples.sweep --physics poisson-mms \
        --param domain_size --values 17,33,65 --max-epochs 60

With ``--fused-kernels`` each run's loss goes through the kernels (K3 and
K1 for klsum's energy, K1 for the MMS resmin).
"""

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, save_lines


def run_klsum(value, param, args, run_dir, dev):
    """KL-sum stochastic Poisson training + UQ query (reference
    2_klsum_fem.py workload swept by run-multiple.sh)."""
    from ..data import NumpyLoader
    from ..data.gen_input import sobol_coefficients
    from ..data.parametric import KLSumStochastic
    from ..models import GoodNetwork
    from ..pde import Poisson2D
    from ..train import Trainer, query_statistical

    cfg = {"n_train": args.n_train, "domain_size": args.domain_size,
           "batch_size": args.batch_size, "max_epochs": args.max_epochs,
           param: value}
    n = int(cfg["domain_size"])
    bs = min(int(cfg["batch_size"]), int(cfg["n_train"]))
    train_ds = KLSumStochastic(
        sobol_coefficients(int(cfg["n_train"]), dim=6, seed=0),
        domain_size=n)
    module = Poisson2D(
        GoodNetwork(in_dim=n, out_dim=n, in_channels=3, out_channels=1,
                    filters=8),
        train_ds, domain_size=n, batch_size=bs, loss_type="energy",
        bc1_value=1.0, bc2_value=0.0, fused_kernels=args.fused_kernels)
    tr = Trainer(max_epochs=int(cfg["max_epochs"]), optimizer="adam",
                 learning_rate=3e-4, run_dir=run_dir, checkpoint=True,
                 device=dev)
    tr.fit(module, NumpyLoader(train_ds, bs, shuffle=True, device=dev))
    query_ds = KLSumStochastic(
        sobol_coefficients(int(cfg["n_train"]), dim=6, seed=1),
        domain_size=n)
    mean, sdev, _ = query_statistical(module, query_ds, batch_size=bs,
                                      out_dir=run_dir, device=dev)
    loss = _final_loss(run_dir)
    return {"final_loss": loss, "mean_mid": float(mean[n // 2, n // 2]),
            "sdev_max": float(sdev.max())}, mean, sdev


def run_poisson_mms(value, param, args, run_dir, dev):
    """Poisson 2D MMS resmin LBFGS solve, final rel-L2 (reference
    e2_manufactured_resmin.py acceptance metric)."""
    from ..train import Trainer
    from .poisson_mms_2d import mms_module

    cfg = {"domain_size": args.domain_size,
           "max_epochs": args.max_epochs, param: value}
    n = int(cfg["domain_size"])
    m = mms_module(n, 1, "resmin", args.fused_kernels)
    Trainer(max_epochs=int(cfg["max_epochs"]), optimizer="lbfgs",
            lbfgs_max_iter=10, run_dir=run_dir, checkpoint=True,
            device=dev).fit(m)
    with torch.no_grad():
        u = m.network()[0]
        eL2, _, uex = m.calc_l2_err(u)
    field = host(u)
    return {"final_loss": _final_loss(run_dir),
            "rel_l2": float(eL2 / uex)}, field, np.zeros_like(field)


def _final_loss(run_dir):
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return float(rows[-1]["loss"]) if rows else float("nan")


WORKLOADS = {"klsum": run_klsum, "poisson-mms": run_poisson_mms}
# config fields each workload actually reads back out of cfg — a swept
# --param outside this set would silently produce identical runs
SWEEPABLE = {"klsum": {"n_train", "domain_size", "batch_size",
                       "max_epochs"},
             "poisson-mms": {"domain_size", "max_epochs"}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--physics", choices=sorted(WORKLOADS), default="klsum")
    p.add_argument("--param", default="n_train",
                   help="config field to sweep (e.g. n_train, domain_size)")
    p.add_argument("--values", required=True,
                   help="comma-separated sweep values")
    p.add_argument("--repeats", type=int, default=1,
                   help="independent repeats per value (seeds the "
                        "mean/sdev-across-runs statistics)")
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--n-train", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-epochs", type=int, default=5)
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..train import make_run_dir

    dev = device_of(args, "sweep")
    if args.param not in SWEEPABLE[args.physics]:
        p.error(f"--param {args.param!r} is not swept by "
                f"{args.physics!r}; choose from "
                f"{sorted(SWEEPABLE[args.physics])}")
    values = [int(v) for v in args.values.split(",")]
    sweep_name = f"sweep-{args.physics}-{args.param}"
    sweep_dir = make_run_dir(args.out_dir, sweep_name)
    rows, fields = [], []
    for value in values:
        for rep in range(args.repeats):
            run_dir = os.path.join(sweep_dir, f"{args.param}_{value}",
                                   f"version_{rep}")
            os.makedirs(run_dir, exist_ok=True)
            t0 = time.perf_counter()
            metrics, mean, sdev = WORKLOADS[args.physics](
                value, args.param, args, run_dir, dev)
            wall = time.perf_counter() - t0
            row = {args.param: value, "repeat": rep,
                   "wall_sec": round(wall, 3), **metrics}
            rows.append(row)
            fields.append(mean)
            if args.physics == "poisson-mms":
                # klsum already saved q_mean/q_sdev via query_statistical;
                # the raw field gets a non-misleading name
                np.save(os.path.join(run_dir, "field.npy"), mean)
            print(json.dumps(row))

    # aggregate CSV (the run-mean-sdev.sh equivalent, minus the sed)
    agg_path = os.path.join(sweep_dir, "sweep.csv")
    with open(agg_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)

    # cross-run statistics of the mean fields (per sweep value)
    per_value = {}
    for row, field in zip(rows, fields):
        per_value.setdefault(row[args.param], []).append(field)
    stats = {v: {"mean_of_means": float(np.mean(fs)),
                 "sdev_across_runs": float(np.std([np.mean(f) for f in fs]))}
             for v, fs in per_value.items()}
    with open(os.path.join(sweep_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)

    # aggregate plot (metric vs sweep value, log-log), each value's mean
    # over its repeats
    metric = "rel_l2" if "rel_l2" in rows[0] else "final_loss"
    byv = {}
    for r in rows:
        byv.setdefault(r[args.param], []).append(r[metric])
    xs = sorted(byv)
    ys = [float(np.mean(byv[v])) for v in xs]
    save_lines(os.path.join(sweep_dir, "sweep.png"),
               [[(np.log10(xs), np.log10(np.abs(ys) + 1e-300), "o-",
                  metric)]], (f"log10 {metric} vs log10 {args.param}",))

    print(f"sweep_dir: {sweep_dir}  ({len(rows)} runs -> sweep.csv, "
          f"stats.json, sweep.png)")
    return {"run_dir": sweep_dir, "rows": rows, "stats": stats}


if __name__ == "__main__":
    main()
