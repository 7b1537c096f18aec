"""Stochastic KL-sum diffusivity UQ pipeline (port of
``examples/klsum_uq.py``) — train a parametric network over an ensemble,
then run the statistical query; counterpart of
examples/poisson/parametric/{2_klsum_fem.py,query.py,calc_mean_sdev.py}.

    python -m diffnet_tpu_torch.examples.klsum_uq --n-train 128 \
        --n-query 256 --fused-kernels

With ``--fused-kernels`` the Ritz energy runs K3 (``csrc/poisson2d.cu``)
and its gradient K1.
"""

import argparse
import os

import numpy as np

from ._common import add_port_flags, device_of, save_contours


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--n-train", type=int, default=128)
    p.add_argument("--n-query", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-epochs", type=int, default=10)
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..data import NumpyLoader
    from ..data.gen_input import sobol_coefficients
    from ..data.parametric import KLSumStochastic
    from ..models import GoodNetwork
    from ..pde import Poisson2D
    from ..train import Trainer, make_run_dir, query_statistical

    dev = device_of(args, "klsum_uq")
    n = args.domain_size
    # Sobol low-discrepancy sampling, as in the reference's sobol_6d.npy
    train_coeffs = sobol_coefficients(args.n_train, dim=6, seed=0)
    query_coeffs = sobol_coefficients(args.n_query, dim=6, seed=1)
    train_ds = KLSumStochastic(train_coeffs, domain_size=n)
    module = Poisson2D(
        GoodNetwork(in_dim=n, out_dim=n, in_channels=3, out_channels=1,
                    filters=8),
        train_ds, domain_size=n, batch_size=args.batch_size,
        loss_type="energy", bc1_value=1.0, bc2_value=0.0,
        fused_kernels=args.fused_kernels)
    run_dir = make_run_dir(args.out_dir, "klsum")
    trainer = Trainer(max_epochs=args.max_epochs, optimizer="adam",
                      learning_rate=3e-4, run_dir=run_dir, checkpoint=True,
                      device=dev)
    trainer.fit(module, NumpyLoader(train_ds, args.batch_size, shuffle=True,
                                    device=dev))

    query_ds = KLSumStochastic(query_coeffs, domain_size=n)
    mean, sdev, _ = query_statistical(module, query_ds,
                                      batch_size=args.batch_size,
                                      out_dir=run_dir, device=dev)
    save_contours(os.path.join(run_dir, "uq.png"),
                  {"mean": mean, "sdev": sdev})
    print(f"run_dir: {run_dir}  mean-range "
          f"[{mean.min():.3f},{mean.max():.3f}]  sdev-max {sdev.max():.3f}")
    return {"run_dir": run_dir, "mean": np.asarray(mean),
            "sdev": np.asarray(sdev),
            "params": {k: v.detach().cpu().clone() for k, v in
                       module.network.state_dict().items()}}


if __name__ == "__main__":
    main()
