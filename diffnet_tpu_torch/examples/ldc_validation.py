"""Solve the NS/Stokes lid-driven cavity and overlay midline cuts against
published or conventional-solver data (port of
``scripts/ldc_validation.py``) — the visual counterpart of the
reference's epoch-end overlay plots (e1_ns_ldc_resmin.py:414-424).

    python -m diffnet_tpu_torch.examples.ldc_validation --re 100 \
        --domain-size 48

Re=1000 (beyond the reference's regularized Re=1/100 data) validates
against the classic Ghia, Ghia & Shin (1982) 129^2 benchmark table
(unregularized unit lid) via the Newton-Krylov solver with the
reaction-shifted momentum preconditioner and grid continuation
(33 -> 65 -> 129):

    python -m diffnet_tpu_torch.examples.ldc_validation --re 1000 \
        --solver newton --domain-size 129 --fused-kernels

With ``--fused-kernels`` every residual runs K6 (``csrc/ns2d.cu``). The
Re=1/100 modes overlay the conventional solver's midline files when
``--ref-dir`` names their directory (ns-ldc-numerical-results/), and plot
the solve alone otherwise.
"""

import argparse
import os
import time

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, save_lines

# Ghia, Ghia & Shin, J. Comput. Phys. 48 (1982), Re=1000, 129^2 grid:
# u along the vertical centerline x=0.5 (col: y, u) and v along the
# horizontal centerline y=0.5 (col: x, v).
GHIA_RE1000_U = np.array([
    [1.0000, 1.00000], [0.9766, 0.65928], [0.9688, 0.57492],
    [0.9609, 0.51117], [0.9531, 0.46604], [0.8516, 0.33304],
    [0.7344, 0.18719], [0.6172, 0.05702], [0.5000, -0.06080],
    [0.4531, -0.10648], [0.2813, -0.27805], [0.1719, -0.38289],
    [0.1016, -0.29730], [0.0703, -0.22220], [0.0625, -0.20196],
    [0.0547, -0.18109], [0.0000, 0.00000]])
GHIA_RE1000_V = np.array([
    [1.0000, 0.00000], [0.9688, -0.21388], [0.9609, -0.27669],
    [0.9531, -0.33714], [0.9453, -0.39188], [0.9063, -0.51550],
    [0.8594, -0.42665], [0.8047, -0.31966], [0.5000, 0.02526],
    [0.2344, 0.32235], [0.2266, 0.33075], [0.1563, 0.37095],
    [0.0938, 0.32627], [0.0781, 0.30353], [0.0703, 0.29012],
    [0.0625, 0.27485], [0.0000, 0.00000]])


def continuation_grids(n: int) -> list[int]:
    """n and its node-aligned halvings down to the first at most 49."""
    grids = [n]
    while grids[0] > 49:
        if (grids[0] - 1) % 2:
            break
        grids.insert(0, (grids[0] - 1) // 2 + 1)
    return grids


def solve_newton(n, re, dev, fused=False):
    """Grid-continuation Newton-Krylov solve (49 -> ... -> n, node-aligned
    halvings) with the reaction-shifted momentum MG; unregularized lid for
    the Ghia comparison. Returns u, v and one dict per level (its Newton
    iterations, |F| history and seconds)."""
    from ..data.flow import NSLDCDataset
    from ..pde import NavierStokes, ldc_bcs
    from ..train.continuation import prolong_field
    from ..train.linear import ns_newton_solve

    x0, levels = None, []
    for nn_ in continuation_grids(n):
        ds = NSLDCDataset(domain_sizes=(nn_, nn_), Re=re)
        ds.n_samples = 1
        u_bc, v_bc, p_bc = ldc_bcs((nn_, nn_), regularized=(re != 1000))
        m = NavierStokes(None, ds, domain_size=nn_, batch_size=1, Re=re,
                         u_bc=u_bc, v_bc=v_bc, p_bc=p_bc,
                         fused_kernels=fused)
        t0 = time.perf_counter()
        (u, v, p), info = ns_newton_solve(
            m, newton_iters=30, tol=1e-6, gmres_iters=max(150, 2 * nn_),
            restart=30, x0=x0, lm0=(1e-3 if re >= 400 else 0.0),
            momentum_reaction="auto", device=dev)
        levels.append({"n": nn_, "newton_iters": info["newton_iters"],
                       "residual_history": info["residual_history"],
                       "final_F": info["residual_history"][-1],
                       "seconds": time.perf_counter() - t0})
        print(f"n={nn_}: newton iters={info['newton_iters']} "
              f"|F|={info['residual_history'][-1]:.1e}")
        if nn_ != n:
            fs = (2 * nn_ - 1,) * 2
            x0 = {k: prolong_field(torch.as_tensor(f), fs)
                  for k, f in (("u", u), ("v", v), ("p", p))}
    return u, v, levels


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # choices are the Re values with benchmark data to validate AGAINST:
    # reference-repo files at 1/100, the Ghia table at 1000 (plain solves
    # at other Re: diffnet_tpu_torch.examples.ns_ldc)
    p.add_argument("--re", type=int, default=100, choices=[1, 100, 1000])
    p.add_argument("--domain-size", type=int, default=48)
    p.add_argument("--max-epochs", type=int, default=500)
    p.add_argument("--solver", choices=("train", "newton"), default="train",
                   help="'newton' = ns_newton_solve with grid continuation "
                        "(required for re >= 400; odd domain-size)")
    p.add_argument("--out", default="runs/ldc_validation.png")
    p.add_argument("--ref-dir", default=None,
                   help="directory of midline_cuts_Re{1,100}_regularized_"
                        "128x128.txt (Re 1/100 only); default: no overlay")
    add_port_flags(p)
    args = p.parse_args(argv)

    dev = device_of(args, "ldc_validation")
    ref, ghia = None, None
    if args.re == 1000:
        # no conventional-solver file at this Re; Ghia et al. is the anchor
        ghia = (GHIA_RE1000_U, GHIA_RE1000_V)
    elif args.ref_dir is not None:
        fname = f"midline_cuts_Re{args.re}_regularized_128x128.txt"
        ref = np.loadtxt(os.path.join(args.ref_dir, fname), delimiter=",",
                         skiprows=1)

    n = args.domain_size
    if args.re >= 400 and args.solver != "newton":
        p.error("--re >= 400 needs --solver newton (the training path is "
                "validated at Re <= 100)")
    if args.solver == "newton":
        if n % 2 == 0:
            p.error("--solver newton needs an odd --domain-size "
                    "(node-aligned grid continuation), e.g. 49/97/129")
        u, v, levels = solve_newton(n, args.re, dev, args.fused_kernels)
        return dict(_plot(args, n, u, v, ref, ghia), levels=levels)

    from ..data.flow import NSLDCDataset
    from ..models import DirectField
    from ..pde import NavierStokes, ldc_bcs
    from ..train.continuation import coarse_to_fine

    def factory(nn_):
        ds = NSLDCDataset(domain_sizes=(nn_, nn_), Re=args.re)
        ds.n_samples = 1
        u_bc, v_bc, p_bc = ldc_bcs((nn_, nn_))
        net = DirectField((nn_, nn_), init=np.zeros((nn_, nn_)), n_fields=3)
        m_ = NavierStokes(net, ds, domain_size=nn_, batch_size=1, Re=args.re,
                          u_bc=u_bc, v_bc=v_bc, p_bc=p_bc,
                          loss_norm="squared",
                          fused_kernels=args.fused_kernels)
        return m_, net

    # coarse-to-fine continuation for fine grids (see train/continuation.py)
    grids = [48, n] if n > 48 else [n]
    epochs = ([args.max_epochs, args.max_epochs]
              if len(grids) == 2 else [args.max_epochs])
    m, _ = coarse_to_fine(factory, grids=grids, epochs=epochs, device=dev)
    ds = NSLDCDataset(domain_sizes=(n, n), Re=args.re)
    inputs = torch.from_numpy(ds[0][0])[None].to(dev)
    with torch.no_grad():
        u, v, _ = m.apply_bcs(m.network(inputs), inputs)
    return _plot(args, n, host(u)[0], host(v)[0], ref, None)


def _plot(args, n, u, v, ref, ghia) -> dict:
    y = np.linspace(0, 1, n)
    label = f"diffnet_tpu_torch {n}^2"
    panels = [[(y, u[:, n // 2], "-", label)], [(y, v[n // 2, :], "-", label)]]
    out = {"u": u, "v": v}
    if ref is not None:
        panels[0].append((ref[:, 0], ref[:, 1], "--",
                          "conventional solver 128^2"))
        panels[1].append((ref[:, 0], ref[:, 2], "--",
                          "conventional solver 128^2"))
        err_u = np.abs(u[:, n // 2] - np.interp(y, ref[:, 0], ref[:, 1]))
        err_v = np.abs(v[n // 2, :] - np.interp(y, ref[:, 0], ref[:, 2]))
        out.update(ref_err_u=float(err_u.max()), ref_err_v=float(err_v.max()))
        print(f"Re={args.re}: u-midline max err {err_u.max():.4f}, "
              f"v-midline max err {err_v.max():.4f}")
    if ghia is not None:
        gu, gv = ghia
        panels[0].append((gu[:, 0], gu[:, 1], "o", "Ghia et al. 1982 (129^2)"))
        panels[1].append((gv[:, 0], gv[:, 1], "o", "Ghia et al. 1982 (129^2)"))
        err_u = np.abs(np.interp(gu[:, 0], y, u[:, n // 2]) - gu[:, 1])
        err_v = np.abs(np.interp(gv[:, 0], y, v[n // 2, :]) - gv[:, 1])
        out.update(ghia_err_u=float(err_u.max()),
                   ghia_err_v=float(err_v.max()))
        print(f"Re={args.re}: Ghia u-midline max err {err_u.max():.4f}, "
              f"v-midline max err {err_v.max():.4f}")
    save_lines(args.out, panels, (f"u at x=0.5 (Re={args.re})",
                                  "v at y=0.5"))
    print(f"wrote {args.out}")
    return dict(out, out=args.out)


if __name__ == "__main__":
    main()
