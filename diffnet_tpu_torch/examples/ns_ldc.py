"""Navier-Stokes lid-driven cavity (VMS) (port of ``examples/ns_ldc.py``)
— counterpart of examples/navier-stokes/single_instance/
e1_ns_ldc_resmin.py.

    python -m diffnet_tpu_torch.examples.ns_ldc --domain-size 32 --re 100 \
        --max-epochs 200 --fused-kernels
    python -m diffnet_tpu_torch.examples.ns_ldc --domain-size 33 \
        --solver newton --fused-kernels

With ``--fused-kernels`` every residual runs K6 (``csrc/ns2d.cu``).
"""

import argparse
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, save_contours


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--re", type=float, default=100)
    p.add_argument("--max-epochs", type=int, default=200)
    p.add_argument("--solver", choices=("lbfgs", "newton"), default="lbfgs",
                   help="lbfgs: reference-style residual-norm descent; "
                        "newton: Newton-Krylov on the full VMS system "
                        "(train.linear.ns_newton_solve — quadratic "
                        "convergence, ~4 iterations at Re=100)")
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..data.flow import NSLDCDataset
    from ..models import DirectField
    from ..pde import NavierStokes, ldc_bcs
    from ..train import Trainer, make_run_dir

    dev = device_of(args, "ns_ldc")
    n = args.domain_size
    ds = NSLDCDataset(domain_sizes=(n, n), Re=args.re)
    ds.n_samples = 1
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    module = NavierStokes(
        DirectField((n, n), init=np.zeros((n, n)), n_fields=3), ds,
        domain_size=n, batch_size=1, Re=args.re, u_bc=u_bc, v_bc=v_bc,
        p_bc=p_bc, loss_norm="squared", fused_kernels=args.fused_kernels)
    run_dir = make_run_dir(args.out_dir, f"ns-ldc-re{int(args.re)}")
    out = {"run_dir": run_dir}
    if args.solver == "newton":
        from ..train import ns_newton_solve

        if n % 2 == 0:
            raise SystemExit(
                f"--solver newton needs an odd --domain-size (got {n}): "
                "the momentum-MG hierarchy halves node-aligned grids "
                "(2^k + 1); an even n degenerates it to a dense "
                "pseudo-inverse of the full fine operator")
        # advection-dominated regimes need the damped + reaction-shifted
        # configuration (see ns_newton_solve docstring: Re=400 stalls
        # undamped, Re=1000 stalls without the screened-Laplacian shift)
        high_re = args.re >= 400
        (u, v, pr), info = ns_newton_solve(
            module, lm0=(1e-3 if high_re else 0.0),
            momentum_reaction=("auto" if high_re else 0.0),
            gmres_iters=(150 if high_re else 40),
            restart=(30 if high_re else 10), newton_iters=30, device=dev)
        out.update(newton_iters=info["newton_iters"],
                   final_F=info["residual_history"][-1])
        print(f"newton iters: {info['newton_iters']}  "
              f"|F|: {info['residual_history'][-1]:.3e}")
    else:
        trainer = Trainer(max_epochs=args.max_epochs, optimizer="lbfgs",
                          lbfgs_max_iter=10, run_dir=run_dir,
                          checkpoint=True, device=dev)
        trainer.fit(module)
        inputs = torch.from_numpy(ds[0][0])[None].to(dev)
        with torch.no_grad():
            u, v, pr = (host(a)[0] for a in module.apply_bcs(
                module.network(inputs), inputs))
    save_contours(os.path.join(run_dir, "fields.png"),
                  {"u": u, "v": v, "p": pr})
    # midline cuts (the reference's comparison format,
    # ns-ldc-numerical-results/midline_cuts_*.txt)
    mid = n // 2
    x = np.linspace(0, 1, n)
    np.savetxt(os.path.join(run_dir, "midline_cuts.csv"),
               np.column_stack([x, u[:, mid], v[mid, :], pr[-1, :]]),
               delimiter=",", header="coord,u_at_x0.5,v_at_y0.5,p_at_y1",
               comments="")
    print(f"run_dir: {run_dir}")
    return dict(out, u=u, v=v, p=pr)


if __name__ == "__main__":
    main()
