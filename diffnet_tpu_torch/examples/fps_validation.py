"""Flow-past-square validation (port of ``scripts/fps_validation.py``, the
counterpart of ``ldc_validation`` for the channel configurations).

Solves the NS (Re 10/20/30, L12 x H6) and Stokes (Re 1, L12/L18 x H5)
flow-past-square cases with the direct solver stack at a chosen grid
spacing and prints each case's midline figures. When ``--ref-dir`` names
the directory of the reference's conventional-solver anchors
(``ns-ldc-numerical-results/``, ``stokes-fps/``), it overlays the midline
cuts on them and prints the markdown error table; without it no anchor
is read and no error is printed.

    python -m diffnet_tpu_torch.examples.fps_validation --h 0.25 \
        --out runs/fps_validation
    python -m diffnet_tpu_torch.examples.fps_validation --h 0.125 \
        --cases ns30 --ref-dir DIR

The solver settings are the JAX script's: Newton 30 iterations to |F| <
1e-6, GMRES 80 a direction with restart 20; Stokes GMRES to 1e-7,
maxiter 200, restart 20. No kernel runs here: K6 takes square grids
only, and the channel's is not (``--fused-kernels`` is refused).
"""

import argparse
import os

import numpy as np

from ._common import add_port_flags, device_of, no_kernel, save_lines

CASES = ("ns10", "ns20", "ns30", "stokes12", "stokes18")


def case_geometry(case):
    """(eq, Re, Lx, Ly) of a case name."""
    if case.startswith("ns"):
        return "ns", int(case[2:]), 12.0, 6.0
    return "stokes", 1, float(case[6:]), 5.0


def solve_case(eq, Re, Lx, Ly, h, device="cuda"):
    """The channel solve: ``(u, v, p, nx, ny, info)``, the fields as numpy
    ``[ny, nx]`` and ``info`` the solver's (Newton: its iterations and
    |F| history; Stokes: GMRES's info, 0 where it met its tolerance)."""
    from ..data.flow import NSFPSChannelDataset
    from ..pde.flow import NavierStokes, StokesNSBase
    from ..train.linear import ns_newton_solve, stokes_linear_solve

    nx, ny = int(round(Lx / h)) + 1, int(round(Ly / h)) + 1
    y0 = (Ly - 1.0) / 2.0
    ds = NSFPSChannelDataset(domain_lengths=(Lx, Ly), domain_sizes=(nx, ny),
                             obstacle=((2.0, y0), (3.0, y0 + 1.0)), Re=Re)
    cls = NavierStokes if eq == "ns" else StokesNSBase
    m = cls(None, ds, domain_lengths=(Lx, Ly), domain_sizes=(nx, ny),
            batch_size=1, Re=Re, u_bc=ds.u_bc, v_bc=ds.v_bc, p_bc=ds.p_bc,
            pressure_gauge="dirichlet")
    if eq == "ns":
        (u, v, p), info = ns_newton_solve(m, newton_iters=30, tol=1e-6,
                                          gmres_iters=80, restart=20,
                                          device=device)
    else:
        (u, v, p), res = stokes_linear_solve(m, tol=1e-7, maxiter=200,
                                             restart=20, device=device)
        info = {"gmres_info": int(res)}
    return u, v, p, nx, ny, info


def midline_cuts(u, v, p, Lx, Ly, h) -> dict:
    """The cuts the anchors hold: u and p along y = Ly/2 (midline X), u
    and v along x = 2.5 (midline Y)."""
    ny, nx = u.shape
    jmid, i = ny // 2, int(round(2.5 / h))
    return {"x": np.linspace(0, Lx, nx), "y": np.linspace(0, Ly, ny),
            "uX": u[jmid, :], "pX": p[jmid, :], "uY": u[:, i],
            "vY": v[:, i]}


def load_anchor(fname, Lx):
    ref = np.genfromtxt(fname, delimiter=",", skip_header=1)
    ok = ~np.isnan(ref[:, 2]) & (ref[:, 0] <= Lx + 1e-9)
    return ref[ok, 0], ref[ok, 1], ref[ok, 2], ref[ok, 3]


def anchor_files(case, ref_dir):
    """The midline-X and (NS only) midline-Y anchors of a case."""
    eq, Re, Lx, _ = case_geometry(case)
    if eq == "ns":
        d = os.path.join(ref_dir, "ns-ldc-numerical-results")
        return (os.path.join(d, f"re-{Re}-ns-L12-H6-midlineX.csv"),
                os.path.join(d, f"re-{Re}-ns-L12-H6-midlineY.csv"))
    tag = "-L12" if int(Lx) == 12 else ""
    return (os.path.join(ref_dir, "stokes-fps",
                         f"re-1-stokes{tag}-midlineX.csv"), None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--h", type=float, default=0.25)
    ap.add_argument("--cases", nargs="*", default=list(CASES),
                    choices=CASES)
    ap.add_argument("--out", default="runs/fps_validation")
    ap.add_argument("--ref-dir", default=None,
                    help="directory holding ns-ldc-numerical-results/ and "
                         "stokes-fps/ (the anchor CSVs); default: none, "
                         "no comparison")
    add_port_flags(ap)
    args = ap.parse_args(argv)
    no_kernel(ap, args, "the rectangular channel")
    dev = device_of(args, "fps_validation")

    os.makedirs(args.out, exist_ok=True)
    rows, solved = [], {}
    for case in args.cases:
        eq, Re, Lx, Ly = case_geometry(case)
        fX = fY = None
        if args.ref_dir is not None:
            fX, fY = anchor_files(case, args.ref_dir)
            if not os.path.exists(fX):
                print(f"skip {case}: no anchor {fX}")
                continue

        u, v, p, nx, ny, info = solve_case(eq, Re, Lx, Ly, args.h, dev)
        cuts = midline_cuts(u, v, p, Lx, Ly, args.h)
        solved[case] = dict(cuts, u=u, v=v, p=p, info=info)
        series = [[(cuts["x"], cuts["uX"], "-", "diffnet_tpu_torch")]]
        titles = [f"{case} u @ midline-X"]
        if eq == "ns":
            series.append([(cuts["y"], cuts["uY"], "-",
                            "diffnet_tpu_torch")])
            titles.append(f"{case} u @ x=2.5")
        print(f"{case}: {nx}x{ny}, u @ midline-X max "
              f"{cuts['uX'].max():.4f} min {cuts['uX'].min():.4f}, "
              f"p @ midline-X inlet {cuts['pX'][0]:.4f}"
              + (f", u @ x=2.5 max {cuts['uY'].max():.4f}, v @ x=2.5 max "
                 f"|{np.abs(cuts['vY']).max():.4f}|" if eq == "ns" else "")
              + (f"; newton iters {info['newton_iters']} |F| "
                 f"{info['residual_history'][-1]:.1e}" if eq == "ns"
                 else f"; gmres info {info['gmres_info']}"),
              flush=True)
        if fX is None:
            save_lines(os.path.join(args.out, f"{case}.png"), series,
                       titles)
            continue

        xs, ps, us, _ = load_anchor(fX, Lx)
        eu = np.abs(np.interp(xs, cuts["x"], cuts["uX"]) - us).max()
        ep = np.abs(np.interp(xs, cuts["x"], cuts["pX"]) - ps).mean()
        row = {"case": case, "grid": f"{nx}x{ny}", "uX_max": eu,
               "pX_mean": ep}
        series[0].append((xs, us, ".", "anchor"))
        if fY:
            ys, _, usY, vsY = load_anchor(fY, Ly)
            row["uY_max"] = np.abs(np.interp(ys, cuts["y"], cuts["uY"])
                                   - usY).max()
            row["vY_max"] = np.abs(np.interp(ys, cuts["y"], cuts["vY"])
                                   - vsY).max()
            series[1].append((ys, usY, ".", "anchor"))
        save_lines(os.path.join(args.out, f"{case}.png"), series, titles)
        rows.append(row)
        print(row, flush=True)

    if args.ref_dir is None:
        print("no anchors given (--ref-dir): midline figures only, no "
              "error table")
        return {"solved": solved, "rows": rows, "out": args.out}
    print("\n| case | grid | uX max | pX mean | uY max | vY max |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['case']} | {r['grid']} | {r['uX_max']:.4f} | "
              f"{r['pX_mean']:.4f} | {r.get('uY_max', float('nan')):.4f} | "
              f"{r.get('vY_max', float('nan')):.4f} |")
    return {"solved": solved, "rows": rows, "out": args.out}


if __name__ == "__main__":
    main()
