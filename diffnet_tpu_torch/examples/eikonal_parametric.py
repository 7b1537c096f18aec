"""Parametric eikonal/IBN ensemble (port of
``examples/eikonal_parametric.py``): train a point-cloud -> solution-grid
network over an ENSEMBLE of boundary clouds, then evaluate on held-out
geometries — counterpart of examples/eiqonal/parametric/02_sum.py
(ImmDiff), 05_largenet.py (ImmDiff_Large), 06_normals.py (points+normals
input) and 03_sum_vae.py (VAE head with KL regularization).

The problem is the reference's winding-number-masked Poisson fill
(02_sum.py:131-185: -lap(u) = 1 outside, u = 0 inside the winding
occupancy, threshold 0.1 per 02_sum.py:160). Loss choices:
  * 'energy' (default): the Ritz functional — same minimizer as the
    Galerkin residual, but conditioned for first-order optimizers.
  * 'resmin': the reference's loss_poisson_windingnumber (sum R^2),
    kept for parity.
Held-out clouds are scored against the DIRECT single-geometry Krylov
solution of the same immersed problem
(train.linear.module_linear_solve through IBNPoisson2D.residual_for_field).

    python -m diffnet_tpu_torch.examples.eikonal_parametric --net immdiff \
        --n-train 6 --domain-size 64 --max-epochs 300

The IBN losses have no fused kernel: ``--fused-kernels`` is refused.
"""

import argparse
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, no_kernel, \
    save_contours


def build_network(name, n, n_points):
    from ..models.pointnets import (ImmDiff, ImmDiffLarge,
                                    ImmDiffLargeNormals, ImmDiffVAE)
    if name == "immdiff":
        return ImmDiff(n_points, out_size=n), "cloud"
    if name == "large":
        return ImmDiffLarge(n_points, out_size=n), "cloud"
    if name == "normals":
        return ImmDiffLargeNormals(n_points, out_size=n), "cloud_normals"
    if name == "vae":
        return ImmDiffVAE(n_points, out_size=n), "cloud"
    raise SystemExit(f"unknown --net {name}")


def _batch(cloud, n, dev):
    return (torch.as_tensor(cloud, device=dev)[None],
            torch.ones((1, n, n, 1), device=dev),
            torch.zeros((1, n, n, 1), device=dev))


def heldout_errors(module, clouds, n, dev):
    """Relative L2 of the network prediction vs the direct Krylov solve of
    each cloud's own immersed problem (exterior nodes only)."""
    from ..train.linear import module_linear_solve

    errs = []
    for cloud in clouds:
        with torch.no_grad():
            u_net, inputs, _ = module(_batch(cloud, n, dev))
            u_net = host(module.apply_bcs(u_net, inputs))[0]
        inputs = host(inputs)[0]
        u_ref, _ = module_linear_solve(
            module, inputs_tensor=inputs,
            forcing_tensor=np.ones((n, n, 1), np.float32), tol=1e-8,
            device=dev)
        out = inputs[..., 1] < 0.5
        err = (np.linalg.norm((u_net - u_ref)[out])
               / (np.linalg.norm(u_ref[out]) + 1e-30))
        errs.append(float(err))
    return errs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--net", choices=("immdiff", "large", "normals", "vae"),
                   default="immdiff")
    p.add_argument("--loss", choices=("energy", "resmin"), default="energy")
    p.add_argument("--n-train", type=int, default=6)
    p.add_argument("--n-test", type=int, default=2)
    p.add_argument("--n-points", type=int, default=150)
    p.add_argument("--domain-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--max-epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)
    no_kernel(p, args, "the IBN loss")

    from ..data.geometry_datasets import ParametricNURBS
    from ..data.loader import NumpyLoader
    from ..pde.ibn import IBNPoisson2D
    from ..train import Trainer, make_run_dir

    dev = device_of(args, "eikonal_parametric")
    n = args.domain_size
    ds = ParametricNURBS(n_samples=args.n_train + args.n_test,
                         n_points=args.n_points, domain_size=n)
    heldout = ds.clouds[args.n_train:]
    ds.clouds = ds.clouds[:args.n_train]
    ds.n_samples = args.n_train

    net, net_input = build_network(args.net, n, ds.clouds[0].shape[0])
    module = IBNPoisson2D(net, ds, source_from="winding",
                          network_input=net_input, ibn_loss_type=args.loss,
                          winding_threshold=0.1, bc1_value=0.0,
                          domain_size=n, batch_size=args.batch_size,
                          learning_rate=args.lr)
    loader = NumpyLoader(ds, batch_size=args.batch_size, shuffle=True,
                         device=dev)
    Trainer(max_epochs=args.max_epochs, optimizer="adam",
            learning_rate=args.lr, device=dev).fit(module, loader)

    train_errs = heldout_errors(module, ds.clouds[:2], n, dev)
    test_errs = heldout_errors(module, heldout, n, dev)
    print(f"train rel-L2 (first 2): {train_errs}")
    print(f"HELD-OUT rel-L2: {test_errs}")

    run_dir = make_run_dir(args.out_dir, f"eik-param-{args.net}")
    with torch.no_grad():
        u, inputs, _ = module(_batch(heldout[0], n, dev))
        u = host(module.apply_bcs(u, inputs))[0]
    save_contours(os.path.join(run_dir, "heldout.png"),
                  {"u_net": u, "chi": host(inputs)[0, ..., 1]})
    with open(os.path.join(run_dir, "errors.txt"), "w") as f:
        f.write(f"train {train_errs}\ntest {test_errs}\n")
    print("run dir:", run_dir)
    return {"run_dir": run_dir, "train_rel_l2": train_errs,
            "heldout_rel_l2": test_errs}


if __name__ == "__main__":
    main()
