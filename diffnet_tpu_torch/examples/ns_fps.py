"""Channel flow past an embedded square block (flow-past-square) (port of
``examples/ns_fps.py``) — counterpart of
examples/navier-stokes/single_instance/e2_ns_fps_resmin.py (NS, L12 x H6,
Re 10-30) and the Stokes variant behind stokes-fps/re-1-stokes-*.csv
(L12/L18 x H5, Re 1).

Solves with the direct solver stack (Newton-Krylov for NS, block-
preconditioned GMRES for Stokes) on the anisotropic channel grid and, when
``--ref-dir`` names the directory of the numerical anchors
(``ns-ldc-numerical-results/``, ``stokes-fps/``), reports midline errors
against them.

    python -m diffnet_tpu_torch.examples.ns_fps --eq ns --re 30 --h 0.25
    python -m diffnet_tpu_torch.examples.ns_fps --eq stokes --length 18 \
        --h 0.125

``--fused-kernels`` sets the module's option (K6); the channel's grid is
not square, which K6 does not take, and the Stokes equations have no
fused path: either raises.
"""

import argparse
import os

import numpy as np

from ._common import add_port_flags, device_of, save_contours


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--eq", choices=("ns", "stokes"), default="ns")
    p.add_argument("--re", type=float, default=30)
    p.add_argument("--length", type=float, default=12.0,
                   help="channel length L (12 for the NS anchors; the "
                        "Stokes anchors exist for 12 and 18)")
    p.add_argument("--height", type=float, default=None,
                   help="channel height H (default: 6 for ns, 5 for "
                        "stokes — the anchor geometries)")
    p.add_argument("--h", type=float, default=0.25,
                   help="grid spacing (1/4 or 1/8 keep the obstacle "
                        "corners on grid nodes)")
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--ref-dir", default=None,
                   help="directory holding ns-ldc-numerical-results/ and "
                        "stokes-fps/: report midline errors against its "
                        "anchor for this case; default: no comparison")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..data.flow import NSFPSChannelDataset
    from ..pde.flow import NavierStokes, StokesNSBase
    from ..train import make_run_dir
    from ..train.linear import ns_newton_solve, stokes_linear_solve

    dev = device_of(args, "ns_fps")
    Lx = args.length
    Ly = args.height or (6.0 if args.eq == "ns" else 5.0)
    nx, ny = int(round(Lx / args.h)) + 1, int(round(Ly / args.h)) + 1
    # obstacle of the checked-in anchors: unit square x in [2,3], centered
    # in height (see NSFPSChannelDataset docstring for the geometry
    # forensics vs the reference script's integer-index placement)
    y0 = (Ly - 1.0) / 2.0
    ds = NSFPSChannelDataset(domain_lengths=(Lx, Ly), domain_sizes=(nx, ny),
                             obstacle=((2.0, y0), (3.0, y0 + 1.0)),
                             Re=args.re)
    cls = NavierStokes if args.eq == "ns" else StokesNSBase
    m = cls(None, ds, domain_lengths=(Lx, Ly), domain_sizes=(nx, ny),
            batch_size=1, Re=args.re, u_bc=ds.u_bc, v_bc=ds.v_bc,
            p_bc=ds.p_bc, pressure_gauge="dirichlet",
            fused_kernels=args.fused_kernels)
    if args.eq == "ns":
        (u, v, p), info = ns_newton_solve(m, newton_iters=25, tol=1e-7,
                                          gmres_iters=60, restart=20,
                                          device=dev)
        res = info["residual_history"][-1]
    else:
        (u, v, p), res = stokes_linear_solve(m, tol=1e-7, maxiter=200,
                                             restart=20, device=dev)
    print(f"solved {args.eq} Re={args.re} on {nx}x{ny}; final info: {res}")

    run_dir = make_run_dir(args.out_dir, f"fps-{args.eq}-re{int(args.re)}")
    np.savez(os.path.join(run_dir, "solution.npz"), u=u, v=v, p=p)
    save_contours(os.path.join(run_dir, "contours.png"),
                  {"u": u, "v": v, "p": p})
    out = {"run_dir": run_dir, "u": u, "v": v, "p": p}

    # midline comparison vs the numerical anchors, when named
    if args.eq == "ns":
        fname = ("ns-ldc-numerical-results/"
                 f"re-{int(args.re)}-ns-L12-H6-midlineX.csv")
    else:
        tag = "-L12" if int(Lx) == 12 else ""
        fname = f"stokes-fps/re-1-stokes{tag}-midlineX.csv"
    if args.ref_dir is not None:
        fname = os.path.join(args.ref_dir, fname)
        ref = np.genfromtxt(fname, delimiter=",", skip_header=1)
        ok = ~np.isnan(ref[:, 2]) & (ref[:, 0] <= Lx + 1e-9)
        xs, ps, us = ref[ok, 0], ref[ok, 1], ref[ok, 2]
        x = np.linspace(0, Lx, nx)
        jmid = ny // 2
        ui = np.interp(xs, x, u[jmid, :])
        pi = np.interp(xs, x, p[jmid, :])
        out.update(u_err_max=float(np.abs(ui - us).max()),
                   p_err_mean=float(np.abs(pi - ps).mean()))
        print(f"midline-X vs {os.path.basename(fname)}: "
              f"u err max {np.abs(ui - us).max():.4f} "
              f"mean {np.abs(ui - us).mean():.4f}; "
              f"p err mean {np.abs(pi - ps).mean():.4f}")
    print("run dir:", run_dir)
    return out


if __name__ == "__main__":
    main()
