"""Parametric Navier-Stokes flow past embedded objects (port of
``examples/ns_fpc_parametric.py``): an obstacle-image ensemble drives a
shared-encoder multi-head U-Net producing (u, v, p), trained on the VMS
residuals with per-field round-robin updates — counterpart of
examples/navier-stokes/parametric/e2_ns_fpc_embedded_airfoil.py:241-414.

Uses synthetic ellipse obstacles, or the obstacle image that
``--obstacle-image`` names (e.g. af_images/fpa_bc_128x64.npy), augmented
by shifts.

    python -m diffnet_tpu_torch.examples.ns_fpc_parametric --max-epochs 50 \
        --n-samples 16

``--fused-kernels`` sets the module's option (K6); K6 takes square grids
only, so on the default 128 x 64 channel its wrapper raises.
"""

import argparse
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, save_contours


def load_obstacles(n_samples, shape, domain_lengths, seed=0, image=None):
    """Synthetic ellipses, or the obstacle mask in ``image`` (a .npy) plus
    shift augmentations when one is named."""
    from ..data.flow import synthetic_obstacles

    if image is not None:
        chi = np.load(image)
        if chi.shape != tuple(shape):
            # nearest-neighbor resample to the requested grid
            iy = np.linspace(0, chi.shape[0] - 1, shape[0]).round().astype(int)
            ix = np.linspace(0, chi.shape[1] - 1, shape[1]).round().astype(int)
            chi = chi[np.ix_(iy, ix)]
        rng = np.random.default_rng(seed)
        chis = [chi]
        for _ in range(n_samples - 1):
            sy = int(rng.integers(-shape[0] // 8, shape[0] // 8 + 1))
            sx = int(rng.integers(-shape[1] // 10, shape[1] // 10 + 1))
            chis.append(np.roll(np.roll(chi, sy, 0), sx, 1))
        return chis, "airfoil"
    return synthetic_obstacles(n_samples, shape, domain_lengths,
                               seed=seed), "synthetic"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--n-samples", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--re", type=float, default=100)
    p.add_argument("--max-epochs", type=int, default=50)
    p.add_argument("--base-filters", type=int, default=8)
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--obstacle-image", default=None,
                   help="obstacle mask (.npy) to augment by shifts; "
                        "default: synthetic ellipses")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..data.flow import FlowPastObjectEnsemble
    from ..data.loader import NumpyLoader
    from ..models.networks import MultiOutUNet
    from ..pde import NavierStokes
    from ..train import Trainer, make_run_dir

    dev = device_of(args, "ns_fpc_parametric")
    ny, nx = args.height, args.width
    L = (4.0, 1.0)
    chis, kind = load_obstacles(args.n_samples, (ny, nx), L,
                                image=args.obstacle_image)
    print(f"obstacle ensemble: {len(chis)} {kind} masks at {ny}x{nx}")
    ds = FlowPastObjectEnsemble(chis, domain_lengths=L, Re=args.re)

    net = MultiOutUNet(ds[0][0].shape[-1], num_outputs=3, out_channels=1,
                       base_filters=args.base_filters)
    module = NavierStokes(net, ds, domain_lengths=L, domain_sizes=(nx, ny),
                          batch_size=args.batch_size, Re=args.re,
                          u_bc=ds.u_bc, loss_norm="squared",
                          fused_kernels=args.fused_kernels)
    run_dir = make_run_dir(args.out_dir, f"ns-fpc-{kind}")
    trainer = Trainer(max_epochs=args.max_epochs, optimizer="adam",
                      learning_rate=3e-4, round_robin=True, run_dir=run_dir,
                      checkpoint=True, device=dev)
    trainer.fit(module, NumpyLoader(ds, args.batch_size, shuffle=True,
                                    drop_last=False, device=dev))

    # visualize the first instance
    inputs = torch.from_numpy(ds[0][0])[None].to(dev)
    with torch.no_grad():
        u, v, pr = (host(a)[0] for a in module.apply_bcs(net(inputs),
                                                         inputs))
    save_contours(os.path.join(run_dir, "fields.png"),
                  {"chi": chis[0], "u": u, "v": v, "p": pr})
    noslip = float(np.abs(u[chis[0] > 0.5]).max())
    print(f"run_dir: {run_dir}  u range [{u.min():.3f}, {u.max():.3f}]  "
          f"no-slip max |u| on object: {noslip:.2e}")
    return {"run_dir": run_dir, "u": u, "v": v, "p": pr,
            "noslip_max_abs_u": noslip}


if __name__ == "__main__":
    main()
