"""Parametric immersed-boundary (IBN) Poisson — the flagship path (port of
``examples/poisson_ibn_parametric.py``); counterpart of
examples/poisson/parametric/IBN_2D.py and
e1_complex_immersed_background.py.

    python -m diffnet_tpu_torch.examples.poisson_ibn_parametric \
        --batch-size 64 --max-epochs 5

The IBN energy has no fused kernel: ``--fused-kernels`` is refused.
"""

import argparse
import os

import torch

from ._common import add_port_flags, device_of, host, no_kernel, \
    save_contours


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--n-samples", type=int, default=512)
    p.add_argument("--max-epochs", type=int, default=5)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--network", default="ae", choices=["ae", "unet", "good"])
    p.add_argument("--data-path", default=None,
                   help="dir with point_cloud.npz/normals.npz; synthetic "
                        "ellipse clouds when omitted")
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--debug", action="store_true", help="fast_dev_run")
    add_port_flags(p)
    args = p.parse_args(argv)
    no_kernel(p, args, "the IBN energy")

    from ..data import NumpyLoader
    from ..data.parametric import PointClouds, SyntheticPointClouds
    from ..models import AE, GoodNetwork, UNet
    from ..pde import IBNPoisson2D
    from ..train import Trainer, make_run_dir

    dev = device_of(args, "poisson_ibn_parametric")
    n = args.domain_size
    if args.data_path:
        train_ds = PointClouds(args.data_path, "train", n)
    else:
        train_ds = SyntheticPointClouds(n_samples=args.n_samples,
                                        domain_size=n)
    loader = NumpyLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                         device=dev)

    if args.network == "ae":
        net = AE(1, 1, dims=8, n_downsample=2)
    elif args.network == "unet":
        net = UNet(1, 1, base_filters=16)
    else:
        net = GoodNetwork(in_dim=n, out_dim=n, in_channels=1, out_channels=1)

    module = IBNPoisson2D(net, domain_size=n, batch_size=args.batch_size,
                          learning_rate=args.learning_rate)
    run_dir = make_run_dir(args.out_dir, "ibn-2d")
    trainer = Trainer(max_epochs=args.max_epochs, optimizer="adam",
                      learning_rate=args.learning_rate, run_dir=run_dir,
                      checkpoint=True, fast_dev_run=args.debug, device=dev)
    trainer.fit(module, loader)

    batch = next(iter(loader))
    with torch.no_grad():
        u, inputs, _ = module(batch)
        u = host(module.apply_bcs(u, inputs))
    save_contours(os.path.join(run_dir, "sample.png"),
                  {"chi": host(inputs[0, ..., 1]),
                   "u": u[0]})  # apply_bcs squeezes the channel
    print(f"run_dir: {run_dir}")
    return {"run_dir": run_dir, "u": u[0]}


if __name__ == "__main__":
    main()
