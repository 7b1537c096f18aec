"""Measure MMS convergence rates across formulations and degrees and write
them as a markdown table (port of ``scripts/convergence_study.py``): the
reference's acceptance criterion is exactly these L2 decays, O(h^2) for
deg-1, O(h^3) for deg-2 and O(h^4) for deg-3 elements (SURVEY.md §4).

    python -m diffnet_tpu_torch.examples.convergence_study [--quick]
    python -m diffnet_tpu_torch.examples.convergence_study --quick \
        --rows poisson-resmin-deg1 poisson-energy-deg1 poisson3d \
        --fused-kernels

Every solve is a direct-field LBFGS fit (10 iterations a step) from
zeros, as the JAX script's. The table goes to ``--out``, by default
``runs/convergence/CONVERGENCE.md``. ``--rows`` picks rows by key
(``ROWS``; all by default). With ``--fused-kernels`` the deg-1 2D resmin
rows run their residual through K1 (``poisson_residual_fused``), the
energy row through K3 (K1 in its gradient) and the 3D row through K5;
a picked row with no fused path refuses the flag. Where the JAX script
pins the CPU unless given ``--tpu``, the port runs where ``--device``
says (the card by default).
"""

import argparse
import math
import os
import time

import numpy as np
import torch

from ._common import add_port_flags, device_label, device_of


def _fit(m, epochs, dev):
    from ..train import Trainer

    return Trainer(max_epochs=epochs, optimizer="lbfgs", lbfgs_max_iter=10,
                   device=dev).fit(m)


def _rel(m, u) -> float:
    with torch.no_grad():
        eL2, _, uex = m.calc_l2_err(u)
    return float(eL2 / uex)


def solve_poisson(n, deg, loss_type, epochs=120, device="cuda",
                  fused_kernels=False):
    from ..data import RectangleManufactured
    from ..models import DirectField
    from ..pde import Poisson2D

    exact = lambda x, y: np.sin(math.pi * x) * np.sin(math.pi * y)
    forcing = lambda x, y: 2 * math.pi**2 * np.sin(math.pi * x) * np.sin(
        math.pi * y)
    ds = RectangleManufactured(domain_size=n)
    ds.n_samples = 1
    m = Poisson2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                  domain_size=n, batch_size=1, fem_basis_deg=deg,
                  loss_type=loss_type, exact_solution=exact, forcing=forcing,
                  mms_dirichlet=True, fused_kernels=fused_kernels)
    _fit(m, epochs, device)
    return _rel(m, m.network()[0])


def solve_helmholtz(n, epochs=100, device="cuda"):
    from ..data import RectangleHelmholtzManufactured
    from ..models import DirectField
    from ..pde import Helmholtz2D

    ds = RectangleHelmholtzManufactured(domain_size=n)
    ds.n_samples = 1
    m = Helmholtz2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                    domain_size=n, batch_size=1, exact_solution=ds.exact)
    _fit(m, epochs, device)
    return _rel(m, m.network()[0])


def solve_spacetime(n, epochs=300, device="cuda"):
    from ..data import SpaceTimeRectangleManufactured
    from ..models import DirectField
    from ..pde import SpaceTimeHeat

    ds = SpaceTimeRectangleManufactured(domain_size=n)
    ds.n_samples = 1
    decay, nu = ds.decay_rt, ds.diffusivity
    exact = lambda x, y: np.sin(math.pi * x) * np.exp(-decay * y)
    forcing = lambda x, y: (np.sin(math.pi * x) * np.exp(-decay * y)
                            * (nu * math.pi**2 - decay))
    m = SpaceTimeHeat(DirectField((n, n), init=np.zeros((n, n))), ds,
                      domain_size=n, batch_size=1, exact_solution=exact,
                      forcing=forcing, u0=ds.u0)
    _fit(m, epochs, device)
    inputs = torch.from_numpy(ds[0][0])[None].to(device)
    with torch.no_grad():
        u = m.apply_bcs(m.network(), inputs)[0]
    return _rel(m, u)


def solve_advdiff(n, epochs=200, device="cuda"):
    """Advection-diffusion + SUPG MMS (u = sin(pi x) sin(pi y), skew
    advection a = (cos30, sin30), nu = 0.05)."""
    from ..data import RectangleManufactured
    from ..models import DirectField
    from ..pde import AdvDiff2D

    ax, ay = math.cos(math.pi / 6), math.sin(math.pi / 6)
    nu = 0.05
    pi = math.pi
    exact = lambda x, y: np.sin(pi * x) * np.sin(pi * y)
    forcing = lambda x, y: (
        ax * pi * np.cos(pi * x) * np.sin(pi * y)
        + ay * pi * np.sin(pi * x) * np.cos(pi * y)
        + nu * 2 * pi**2 * np.sin(pi * x) * np.sin(pi * y))
    ds = RectangleManufactured(domain_size=n)
    ds.n_samples = 1
    m = AdvDiff2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                  adv=(ax, ay), diffusivity=nu, domain_size=n, batch_size=1,
                  forcing=forcing, exact_solution=exact, bc1_value=0.0)
    _fit(m, epochs, device)
    return _rel(m, m.network()[0])


def solve_stokes(n, epochs=400, device="cuda"):
    """Stokes PSPG MMS; returns the u-velocity rel L2 error."""
    from ..data.flow import StokesMMSDataset
    from ..models import DirectField
    from ..pde import StokesMMS

    def factory(nn_):
        ds_ = StokesMMSDataset(domain_size=nn_)
        ds_.n_samples = 1
        net_ = DirectField((nn_, nn_), n_fields=3)
        # row-equalized momentum scaling h/visco (momentum rows ~visco/h^2,
        # continuity ~1/h), as the JAX script: the module default 'auto'
        # (h^2/visco) is tuned for the corner-singular cavity
        m_ = StokesMMS(net_, ds_, domain_size=nn_, batch_size=1, Re=1,
                       loss_norm="squared",
                       momentum_scale=1.0 / (nn_ - 1))
        return m_, net_

    if n > 33:
        # cold LBFGS stalls on the fine-grid least squares (cond(K)^2):
        # warm-start from 33^2 (train/continuation.py)
        from ..train.continuation import coarse_to_fine

        m, _ = coarse_to_fine(factory, grids=[33, n], epochs=[400, epochs],
                              device=device)
    else:
        m, _ = factory(n)
        _fit(m, epochs, device)
    ds = StokesMMSDataset(domain_size=n)
    inputs = torch.from_numpy(ds[0][0])[None].to(device)
    with torch.no_grad():
        u, _, _ = m.apply_bcs(m.network(inputs), inputs)
        jxw = m.jxw_c()
        u_gp = m.gauss_pt_evaluation(u[0])
        ex_gp = torch.from_numpy(np.sin(math.pi * m.xgp) * np.cos(
            math.pi * m.ygp)).to(u_gp)
        e = float(torch.sqrt(torch.sum((u_gp - ex_gp) ** 2 * jxw)))
        ref = float(torch.sqrt(torch.sum(ex_gp ** 2 * jxw)))
    return e / ref


class _BurgersMMS:
    """The space-time Burgers MMS frame: the IC row at t = 0 (bc1) and
    u = 0 on the x walls (bc2); y is time."""
    n_samples = 1

    def __init__(self, n):
        pi = math.pi
        x = np.linspace(0, 1, n)
        self.xx, self.yy = np.meshgrid(x, x)  # y axis = time
        bc1 = np.full((n, n), -10.0)
        bc1_val = np.zeros((n, n))
        bc1[0, :] = 1.0
        bc1_val[0, :] = np.sin(pi * x)          # IC row t=0
        bc2 = np.full((n, n), -10.0)
        bc2[:, 0] = 1.0
        bc2[:, -1] = 1.0                        # x walls, u = 0
        self.inputs = np.stack([self.xx, bc1, bc2, bc1_val],
                               -1).astype(np.float32)
        self.forcing = np.zeros((n, n, 1), np.float32)

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def solve_burgers(n, epochs=300, device="cuda"):
    """Space-time Burgers (deg-2 strong-form collocation) MMS:
    u = sin(pi x) exp(-t), f = u_t + u u_x."""
    from ..models import DirectField
    from ..pde import BurgersSpaceTime

    pi = math.pi
    exact = lambda x, y: np.sin(pi * x) * np.exp(-y)
    forcing = lambda x, y: (-np.sin(pi * x) * np.exp(-y)
                            + np.sin(pi * x) * np.exp(-y)
                            * pi * np.cos(pi * x) * np.exp(-y))
    ds = _BurgersMMS(n)
    m = BurgersSpaceTime(DirectField((n, n), init=np.zeros((n, n))), ds,
                         domain_size=n, batch_size=1, forcing=forcing,
                         exact_solution=exact)
    _fit(m, epochs, device)
    inputs = torch.from_numpy(ds[0][0])[None].to(device)
    return _rel(m, _squeeze_burgers(m, inputs))


def _squeeze_burgers(m, inputs):
    with torch.no_grad():
        u = m.network(inputs)
        u = u[0] if u.ndim > 2 else u
        bc1 = inputs[0, ..., 1]
        bc2 = inputs[0, ..., 2]
        bc1_val = inputs[0, ..., 3]
        u = torch.where(bc1 > 0.5, bc1_val, u)
        return torch.where(bc2 > 0.5, torch.zeros_like(u), u)


def solve_allencahn(n, epochs=250, device="cuda"):
    """Allen-Cahn space-time MMS with manufactured source:
    u = sin(pi x) sin(pi y); operator u_t + D G(u) - D Cn^2 lap(u)."""
    from ..data import AllenCahnIceMeltRectangle
    from ..models import DirectField
    from ..pde import AllenCahnIceMelt

    pi = math.pi
    A, Cn, D, k = 16.0, 0.1, 1.0, 2.0
    exact = lambda x, y: np.sin(pi * x) * np.sin(pi * y)

    def forcing(x, y):
        u = np.sin(pi * x) * np.sin(pi * y)
        u_t = pi * np.sin(pi * x) * np.cos(pi * y)
        G = 2.0 * D * A * (u - 3 * u**2 + 2 * u**3) - D * k
        return u_t + D * G + D * Cn**2 * 2 * pi**2 * u

    def linforcing(x, y):
        # reaction-free (A = 0) counterpart used for the homotopy stage
        u = np.sin(pi * x) * np.sin(pi * y)
        u_t = pi * np.sin(pi * x) * np.cos(pi * y)
        return u_t - D * D * k + D * Cn**2 * 2 * pi**2 * u

    ds = AllenCahnIceMeltRectangle(domain_size=n)
    ds.n_samples = 1
    # MMS Dirichlet frame: IC row (bc1) + sides and top row (bc2): the
    # Cn^2 u_tt term makes the operator elliptic in time
    ds.bc2 = np.zeros((n, n))
    ds.bc2[:, [0, -1]] = 1.0
    ds.bc2[-1, :] = 1.0
    ds.u0 = np.zeros((n, n))
    # homotopy in the reaction strength: solve the A = 0 linear problem,
    # then warm-start the full nonlinear solve from it (LBFGS from zero
    # strands in a spinodal local minimum)
    m1 = AllenCahnIceMelt(DirectField((n, n), init=np.zeros((n, n))), ds,
                          domain_size=n, batch_size=1, ac_A=0.0,
                          forcing=linforcing, exact_solution=exact, u0=ds.u0)
    _fit(m1, epochs, device)
    with torch.no_grad():
        u1 = m1.network()[0].cpu().numpy()
    m = AllenCahnIceMelt(DirectField((n, n), init=u1), ds,
                         domain_size=n, batch_size=1, forcing=forcing,
                         exact_solution=exact, u0=ds.u0)
    _fit(m, epochs, device)
    return _rel(m, m.network()[0])


def solve_poisson3d(n, epochs=60, device="cuda", fused_kernels=False):
    from ..data import CuboidManufactured
    from ..models import DirectField
    from ..pde import Poisson3D

    ds = CuboidManufactured(domain_size=n)
    ds.n_samples = 1
    m = Poisson3D(DirectField((n, n, n), init=np.zeros((n, n, n))), ds,
                  domain_size=n, batch_size=1, loss_type="resmin",
                  exact_solution=ds.exact, forcing=ds.forcing_func,
                  mms_dirichlet=True, fused_kernels=fused_kernels)
    _fit(m, epochs, device)
    return _rel(m, m.network()[0])


def rates_of(grids, errs) -> list:
    """The per-h rate log(e_i / e_{i+1}) / log(h_i / h_{i+1}): exact for
    any refinement ratio (log2 of the error ratio only when grids
    halve)."""
    return [math.log(errs[i] / errs[i + 1])
            / math.log((grids[i + 1] - 1) / (grids[i] - 1))
            for i in range(len(errs) - 1)]


# key -> (row name, quick grids, full grids, expected, the kernel that
# --fused-kernels routes the row through or None, solver(n, dev, fused))
ROWS = {
    "poisson-resmin-deg1": (
        "Poisson 2D resmin deg1", [17, 33], [17, 33, 65], "2 (O(h^2))", "K1",
        lambda n, d, f: solve_poisson(n, 1, "resmin", device=d,
                                      fused_kernels=f)),
    "poisson-energy-deg1": (
        "Poisson 2D energy deg1", [17, 33], [17, 33, 65], "2 (O(h^2))", "K3",
        lambda n, d, f: solve_poisson(n, 1, "energy", epochs=200, device=d,
                                      fused_kernels=f)),
    "poisson-resmin-deg2": (
        "Poisson 2D resmin deg2", [9, 17], [9, 17, 33], "3 (O(h^3))", None,
        lambda n, d, f: solve_poisson(n, 2, "resmin", device=d)),
    "poisson-resmin-deg3": (
        "Poisson 2D resmin deg3", [7, 13], [7, 13, 25], "4 (O(h^4))", None,
        lambda n, d, f: solve_poisson(n, 3, "resmin", device=d)),
    "helmholtz": (
        "Helmholtz 2D (k=0.5)", [17, 33], [17, 33, 65], "2 (O(h^2))", None,
        lambda n, d, f: solve_helmholtz(n, device=d)),
    "spacetime-heat": (
        "Space-time heat (SUPG)", [9, 17], [9, 17, 33], "2 (O(h^2))", None,
        lambda n, d, f: solve_spacetime(n, epochs=300, device=d)),
    "advdiff": (
        "Adv-diff 2D (SUPG, nu=0.05)", [17, 33], [17, 33, 65], "2 (O(h^2))",
        None, lambda n, d, f: solve_advdiff(n, device=d)),
    "stokes": (
        "Stokes 2D PSPG (u field)", [17, 33], [17, 33, 49], "2 (O(h^2))",
        None, lambda n, d, f: solve_stokes(n, device=d)),
    "burgers": (
        "Burgers space-time deg2 (strong)", [9, 17], [9, 17, 33],
        ">=2 (O(h^2))", None, lambda n, d, f: solve_burgers(n, device=d)),
    "allen-cahn": (
        "Allen-Cahn space-time (MMS src)", [9, 17], [9, 17, 33],
        "2 (O(h^2))", None, lambda n, d, f: solve_allencahn(n, device=d)),
    "poisson3d": (
        "Poisson 3D resmin deg1", [9, 17], [9, 17], "2 (O(h^2))", "K5",
        lambda n, d, f: solve_poisson3d(n, device=d, fused_kernels=f)),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="fewer grids (CI-speed)")
    p.add_argument("--out", default=os.path.join("runs", "convergence",
                                                 "CONVERGENCE.md"))
    p.add_argument("--rows", nargs="+", choices=list(ROWS),
                   default=list(ROWS), help="the rows to measure (all by "
                                            "default)")
    add_port_flags(p)
    args = p.parse_args(argv)
    if args.fused_kernels:
        plain = [k for k in args.rows if ROWS[k][4] is None]
        if plain:
            p.error(f"--fused-kernels: {', '.join(plain)} "
                    f"{'has' if len(plain) == 1 else 'have'} no fused "
                    "kernel (pick the rows with --rows)")
    dev = device_of(args, "convergence_study")

    rows = []
    t0 = time.time()

    def rate_row(key, grids, solver, expect):
        name = ROWS[key][0]
        errs, seconds = [], []
        for n in grids:
            ts = time.perf_counter()
            errs.append(solver(n))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - ts)
        rates = rates_of(grids, errs)
        rows.append({"key": key, "name": name, "grids": grids,
                     "errs": errs, "rates": rates, "expect": expect,
                     "seconds": seconds})
        print(f"{name}: errs={['%.2e' % e for e in errs]} "
              f"rates={['%.2f' % r for r in rates]}", flush=True)

    for key in args.rows:
        _, quick, full, expect, _, solver = ROWS[key]
        rate_row(key, quick if args.quick else full,
                 lambda n: solver(n, dev, args.fused_kernels), expect)

    lines = [
        "# Measured MMS convergence rates",
        "",
        "Generated by `python -m diffnet_tpu_torch.examples."
        "convergence_study` (direct-field",
        "LBFGS solves; rates = log(err ratio) / log(h ratio) between",
        "successive grids). The reference's acceptance criterion is",
        "exactly these decays (SURVEY.md §4).",
        "",
        "| problem | grids | rel. L2 errors | measured rates | expected |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            "| %s | %s | %s | %s | %s |" % (
                r["name"], ",".join(map(str, r["grids"])),
                " / ".join("%.2e" % e for e in r["errs"]),
                " / ".join("%.2f" % x for x in r["rates"]), r["expect"]))
    lines.append("")
    lines.append(f"_Total runtime: {time.time() - t0:.0f}s on "
                 f"{'quick' if args.quick else 'full'} grids, on "
                 f"{device_label(dev)}"
                 f"{', fused kernels' if args.fused_kernels else ''}._")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return {"rows": rows, "out": args.out}


if __name__ == "__main__":
    main()
