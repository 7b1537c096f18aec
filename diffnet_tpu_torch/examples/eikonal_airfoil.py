"""Parametric eikonal airfoil (port of ``examples/eikonal_airfoil.py``): a
NURBS boundary cloud (an analytic cambered teardrop as the control
polygon, or the airfoil profile that ``--airfoil-file`` names) ->
generalized winding-number occupancy -> signed-distance reconstruction by
eikonal residual minimization — counterpart of
examples/eiqonal/parametric/09_airfoil.py:238-291.

    python -m diffnet_tpu_torch.examples.eikonal_airfoil --domain-size 64 \
        --max-epochs 200

The eikonal loss has no fused kernel: ``--fused-kernels`` is refused.
"""

import argparse
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, no_kernel, save_contours


def airfoil_control_polygon(n_control=24, path=None):
    """Control polygon in the unit domain: an analytic teardrop, or the
    profile in ``path`` (x y columns, e.g. the e864 .dat) when one is
    named."""
    if path is not None:
        pts = np.loadtxt(path)[:, :2]
        # subsample to a control polygon, scale chord into [0.2, 0.8]
        idx = np.linspace(0, len(pts) - 1, n_control).astype(int)
        ctrl = pts[idx]
        lo, hi = ctrl.min(0), ctrl.max(0)
        scale = 0.6 / (hi[0] - lo[0])
        ctrl = (ctrl - lo) * scale
        ctrl[:, 0] += 0.2
        ctrl[:, 1] += 0.5 - ctrl[:, 1].mean()
        return ctrl, os.path.splitext(os.path.basename(path))[0]
    t = np.linspace(0, 2 * np.pi, n_control, endpoint=False)
    x = 0.5 + 0.3 * np.cos(t)
    y = 0.5 + 0.08 * np.sin(t) * (1.2 - np.cos(t))  # cambered teardrop
    return np.stack([x, y], -1), "teardrop"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain-size", type=int, default=64)
    p.add_argument("--n-points", type=int, default=200)
    p.add_argument("--max-epochs", type=int, default=200)
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--airfoil-file", default=None,
                   help="airfoil profile (x y columns) for the control "
                        "polygon; default: the analytic teardrop")
    add_port_flags(p)
    args = p.parse_args(argv)
    no_kernel(p, args, "the eikonal loss")

    from ..core.geometry import occupancy_from_cloud
    from ..core.interp import grid_interp_2d
    from ..data.geometry_datasets import nurbs_curve
    from ..data.loader import InMemoryDataset, NumpyLoader
    from ..models import DirectField
    from ..pde import Eikonal2D, signed_occupancy_init
    from ..train import Trainer, make_run_dir

    dev = device_of(args, "eikonal_airfoil")
    n = args.domain_size
    ctrl, kind = airfoil_control_polygon(path=args.airfoil_file)
    pts, nrm, area = nurbs_curve(ctrl, n_samples=args.n_points)
    print(f"{kind} NURBS cloud: {len(pts)} points, "
          f"bbox [{pts.min(0)}, {pts.max(0)}]")
    cloud = np.concatenate([pts, nrm, area[:, None]], -1).astype(np.float32)
    ds = InMemoryDataset(cloud[None], np.zeros((1, n, n, 1), np.float32))

    def jp(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]

    chi = host(occupancy_from_cloud(jp(pts), jp(nrm), jp(area), (n, n)))[0]
    print(f"winding occupancy: {chi.mean():.4f} of the domain inside")

    u0 = host(signed_occupancy_init(jp(pts), jp(nrm), jp(area), (n, n)))[0]
    net = DirectField((n, n), init=u0)
    module = Eikonal2D(net, ds, domain_size=n, batch_size=1,
                       sdf_weight=100.0, normals_weight=10.0)
    run_dir = make_run_dir(args.out_dir, f"eikonal-airfoil-{kind}")
    trainer = Trainer(max_epochs=args.max_epochs, optimizer="lbfgs",
                      lbfgs_max_iter=10, run_dir=run_dir, checkpoint=True,
                      device=dev)
    trainer.fit(module, NumpyLoader(ds, batch_size=1, device=dev))

    with torch.no_grad():
        u = net()[0]
        u_pts, _ = grid_interp_2d(u[None], jp(pts),
                                  (1.0 / (n - 1), 1.0 / (n - 1)), deg=1)
    zero_err = float(np.abs(host(u_pts)).mean())
    u = host(u)
    save_contours(os.path.join(run_dir, "sdf.png"),
                  {"chi": chi, "sdf": u, "abs_sdf": np.abs(u)})
    print(f"run_dir: {run_dir}  mean |u| on boundary: {zero_err:.2e} "
          f"(h = {1.0/(n-1):.2e})  sdf range [{u.min():.3f}, {u.max():.3f}]")
    return {"run_dir": run_dir, "u": u, "mean_abs_u_boundary": zero_err}


if __name__ == "__main__":
    main()
