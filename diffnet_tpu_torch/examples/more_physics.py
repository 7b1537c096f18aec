"""One CLI for the remaining single-instance physics (port of
``examples/more_physics.py``): Helmholtz, advection-diffusion (SUPG),
Allen-Cahn ice melt, Burgers space-time, FSDT plate, topology
optimization — counterparts of the reference examples 14_helmholtz_mms,
e17_adv_diff_2d_resmin, e18_allen_cahn_ice_melt, burgers
01_2d_space_time, e1_plate_bending_fsdt, 16_topopt.

    python -m diffnet_tpu_torch.examples.more_physics helmholtz \
        --domain-size 32
    python -m diffnet_tpu_torch.examples.more_physics topopt \
        --max-epochs 200

Only topopt runs a kernel of the port (K1, in every CG matvec of its state
solves, whatever ``--fused-kernels`` says); the other losses have no fused
kernel and refuse ``--fused-kernels``.
"""

import argparse
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, no_kernel, \
    save_contours


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("physics", choices=["helmholtz", "advdiff", "allen-cahn",
                                       "burgers", "fsdt", "topopt"])
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--solver", choices=("lbfgs", "direct"), default="lbfgs",
                   help="direct: Krylov/Newton solver path instead of the "
                        "reference-style LBFGS descent (helmholtz: gmres; "
                        "allen-cahn: Newton with A=0 homotopy)")
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)
    if args.physics != "topopt":
        no_kernel(p, args, f"the {args.physics} loss")

    from ..data.loader import NumpyLoader
    from ..models import DirectField
    from ..train import Trainer, make_run_dir

    dev = device_of(args, "more_physics")
    n = args.domain_size
    run_dir = make_run_dir(args.out_dir, args.physics)
    zero = np.zeros((n, n))
    out = {"run_dir": run_dir}

    def fit(m, loader=None):
        Trainer(max_epochs=args.max_epochs, optimizer="lbfgs",
                lbfgs_max_iter=10, run_dir=run_dir, device=dev).fit(m, loader)

    if args.physics == "helmholtz":
        from ..data.single_instances import RectangleHelmholtzManufactured
        from ..pde import Helmholtz2D

        ds = RectangleHelmholtzManufactured(domain_size=n)
        ds.n_samples = 1
        m = Helmholtz2D(DirectField((n, n), init=zero), ds, domain_size=n,
                        batch_size=1, exact_solution=ds.exact)
        if args.solver == "direct":
            from ..train import module_linear_solve

            u, _ = module_linear_solve(m, method="gmres", tol=1e-10,
                                       maxiter=2000, device=dev)
            u = torch.from_numpy(u).to(dev)
        else:
            fit(m)
            u = m.network()[0]
        with torch.no_grad():
            eL2, _, uex = m.calc_l2_err(u)
        out.update(rel_l2=float(eL2 / uex), u=host(u))
        print(f"helmholtz rel_L2: {float(eL2/uex):.3e}")

    elif args.physics == "advdiff":
        from ..data.single_instances import AdvDiff1dRectangle
        from ..pde import AdvDiff2D

        ds = AdvDiff1dRectangle(domain_size=n)
        ds.n_samples = 1
        m = AdvDiff2D(DirectField((n, n), init=zero), ds, adv=(1.0, 0.0),
                      diffusivity=1e-3, domain_size=n, batch_size=1,
                      bc1_value=0.0, forcing=lambda x, y: np.ones_like(x))
        fit(m)
        u = host(m.network()[0])
        out["u"] = u
        print(f"advdiff u range: [{u.min():.3f}, {u.max():.3f}] (bounded ->"
              " SUPG active)")

    elif args.physics == "allen-cahn":
        from ..data.single_instances import AllenCahnIceMeltRectangle
        from ..pde import AllenCahnIceMelt

        ds = AllenCahnIceMeltRectangle(domain_size=n)
        ds.n_samples = 1
        m = AllenCahnIceMelt(DirectField((n, n), init=ds.initial_guess), ds,
                             domain_size=n, batch_size=1)
        if args.solver == "direct":
            from ..train import newton_solve, solve_linear

            m.to(dev)
            jin = torch.from_numpy(ds[0][0])[None].to(dev)
            bc1, bc2 = jin[..., 1], jin[..., 2]

            # stage 1 (A=0 homotopy): with the double-well dropped the
            # system is AFFINE — one Krylov call gives the warm start the
            # cold double-well Newton needs (same staging as
            # tests/test_linear_solve.py::test_newton_allen_cahn_mms)
            m1 = AllenCahnIceMelt(None, ds, domain_size=n, batch_size=1,
                                  ac_A=0.0).to(dev)

            def F1(u):
                return m1.residual(m1.apply_bcs(u[None], jin), bc1, bc2)[0]

            u_lin, _ = solve_linear(F1, (n, n), method="gmres", tol=1e-8,
                                    maxiter=400, restart=30, device=dev)

            def F(u):
                return m.residual(m.apply_bcs(u[None], jin), bc1, bc2)[0]

            x, info = newton_solve(F, u_lin, newton_iters=30,
                                   gmres_iters=150, restart=25, tol=1e-8,
                                   device=dev)
            out.update(newton_iters=info["newton_iters"],
                       final_F=info["residual_history"][-1])
            print(f"newton iters: {info['newton_iters']}  "
                  f"|F|: {info['residual_history'][-1]:.3e}")
            with torch.no_grad():
                u = host(m.apply_bcs(x[None], jin)[0])
        else:
            fit(m)
            u = host(m.network()[0])
        out["u"] = u
        print(f"allen-cahn phase range: [{u.min():.3f}, {u.max():.3f}]")

    elif args.physics == "burgers":
        from ..data.geometry_datasets import Burg2DXT
        from ..pde import BurgersSpaceTime

        n = n if (n - 1) % 2 == 0 else n + 1
        ds = Burg2DXT(domain_size=n)
        ds.n_samples = 1
        # Burg2DXT's x grid spans [-1, 1] (length 2): pass the physical
        # extents or u_x comes out doubled (wave speed 2x)
        m = BurgersSpaceTime(DirectField((n, n), init=ds.initial_guess), ds,
                             domain_sizes=(n, n), domain_lengths=(2.0, 1.0),
                             batch_size=1)
        fit(m)
        batch = tuple(torch.from_numpy(a)[None].to(dev) for a in ds[0])
        with torch.no_grad():
            loss = float(m.training_loss(batch))
        out["final_loss"] = loss
        print(f"burgers final loss: {loss:.3e}")

    elif args.physics == "fsdt":
        from ..data.geometry_datasets import ElasticFSDTDataset
        from ..pde import ElasticFSDT

        ds = ElasticFSDTDataset(domain_size=n)
        ds.n_samples = 1
        m = ElasticFSDT(DirectField((n, n), init=np.zeros((n, n)),
                                    n_fields=3), ds, domain_size=n,
                        batch_size=1, loss_norm="squared")
        fit(m, NumpyLoader(ds, batch_size=1, device=dev))
        inputs = torch.from_numpy(ds[0][0])[None].to(dev)
        with torch.no_grad():
            w = host(m.apply_bcs(m.network(inputs), inputs)[0])[0]
        out.update(centre_w=float(w[n // 2, n // 2]), w=w)
        print(f"fsdt center deflection: {w[n//2, n//2]:.4f}")

    else:  # topopt
        from ..data.loader import InMemoryDataset
        from ..pde import TopOpt2D

        x = np.linspace(0, 1, n)
        xx, yy = np.meshgrid(x, x)
        bc1 = np.zeros((n, n)); bc1[0, :] = 1
        bc2 = np.zeros((n, n)); bc2[-1, :] = 1
        inputs = np.stack([bc1, bc2, xx, yy], -1).astype(np.float32)
        forcing = np.ones((n, n, 1), np.float32)
        ds = InMemoryDataset(inputs[None], forcing[None])
        m = TopOpt2D(None, ds, domain_size=n, batch_size=1, target_vf=0.4,
                     compliance_form="variational")
        # demonstrated alternating optimization: exact CG state solve /
        # compliance-sensitivity step / exact vf projection per outer
        # iteration (TopOpt2D.optimize docstring)
        rho_raw, u, hist = m.optimize(inputs, forcing,
                                      n_outer=args.max_epochs, device=dev)
        with torch.no_grad():
            rho = host(m.project_density(rho_raw))
        save_contours(os.path.join(run_dir, "density.png"),
                      {"rho": rho, "u": host(u)})
        np.savetxt(os.path.join(run_dir, "compliance.csv"), hist,
                   header="compliance", comments="")
        out.update(rho=rho, compliance=np.asarray(hist))
        print(f"topopt volume fraction: {rho.mean():.4f} (target 0.4)  "
              f"compliance {hist[0]:.3f} -> {hist[-1]:.3f}  "
              f"solid frac {np.mean(rho > 0.5):.2f}")

    print(f"run_dir: {run_dir}")
    return out


if __name__ == "__main__":
    main()
