"""Load a trained run and perform the statistical query (port of
``examples/query_run.py``) — counterpart of
examples/poisson/parametric/query.py + run-query.sh (which key off the
versioned ``name/version_N`` run dirs).

    python -m diffnet_tpu_torch.examples.query_run runs/klsum/version_0 \
        --n-query 256 --fused-kernels

Reads ``best.ckpt`` (else ``last.ckpt``) as the port's trainer wrote it
(``torch.save`` of the network's state dict). With ``--fused-kernels`` the
module is built with the energy through K3, as in training.
"""

import argparse
import os

import numpy as np

from ._common import add_port_flags, device_of, save_contours


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir", help="versioned run dir containing best.ckpt")
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--n-query", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--filters", type=int, default=8)
    p.add_argument("--seed", type=int, default=123)
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..data.parametric import KLSumStochastic
    from ..models import GoodNetwork
    from ..pde import Poisson2D
    from ..train import load_params, query_statistical
    from ..utils import write_vti

    dev = device_of(args, "query_run")
    n = args.domain_size
    net = GoodNetwork(in_dim=n, out_dim=n, in_channels=3, out_channels=1,
                      filters=args.filters)
    ckpt = os.path.join(args.run_dir, "best.ckpt")
    if not os.path.exists(ckpt):
        ckpt = os.path.join(args.run_dir, "last.ckpt")
    net.load_state_dict(load_params(ckpt, map_location="cpu"))

    coeffs = np.random.default_rng(args.seed).normal(
        0, 0.5, (args.n_query, 6))
    query_ds = KLSumStochastic(coeffs, domain_size=n)
    module = Poisson2D(net, query_ds, domain_size=n,
                       batch_size=args.batch_size, loss_type="energy",
                       fused_kernels=args.fused_kernels)
    mean, sdev, all_u = query_statistical(module, query_ds,
                                          batch_size=args.batch_size,
                                          out_dir=args.run_dir, device=dev)
    save_contours(os.path.join(args.run_dir, "query_uq.png"),
                  {"mean": mean, "sdev": sdev})
    write_vti(os.path.join(args.run_dir, "q_mean.vti"), mean)
    write_vti(os.path.join(args.run_dir, "q_sdev.vti"), sdev)
    print(f"queried {len(all_u)} samples -> {args.run_dir}/q_mean.npy, "
          f"q_sdev.npy, query_uq.png, q_*.vti")
    return {"run_dir": args.run_dir, "ckpt": ckpt, "n_queried": len(all_u),
            "mean": np.asarray(mean), "sdev": np.asarray(sdev),
            "params": {k: v.detach().cpu().clone() for k, v in
                       net.state_dict().items()}}


if __name__ == "__main__":
    main()
