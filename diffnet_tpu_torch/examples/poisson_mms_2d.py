"""Poisson 2D MMS solve (port of ``examples/poisson_mms_2d.py``) —
counterpart of the reference's examples/poisson/single_instance/{0_base,
e2_manufactured_resmin,e8_2d_poisson_mms}.py workflows.

    python -m diffnet_tpu_torch.examples.poisson_mms_2d --domain-size 64 \
        --loss-type resmin --optimizer lbfgs --max-epochs 80 --fused-kernels

With ``--fused-kernels`` the resmin residual, the CG matvecs and the fine
level of MG-CG run K1 (``csrc/poisson2d.cu``), the energy K3.
"""

import argparse
import math
import os
import time

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, save_contours


def exact(x, y):
    return np.sin(math.pi * x) * np.sin(math.pi * y)


def forcing(x, y):
    return 2 * math.pi**2 * np.sin(math.pi * x) * np.sin(math.pi * y)


def mms_module(n, deg, loss_type, fused=False, init=True, **kw):
    """The MMS problem on n^2 nodes (DirectField from zeros)."""
    from ..data.single_instances import RectangleManufactured
    from ..models import DirectField
    from ..pde import Poisson2D

    ds = RectangleManufactured(domain_size=n)
    ds.n_samples = 1
    net = DirectField((n, n), init=np.zeros((n, n)) if init else None)
    return Poisson2D(net, ds, domain_size=n, batch_size=1,
                     fem_basis_deg=deg, loss_type=loss_type,
                     exact_solution=exact, forcing=forcing,
                     mms_dirichlet=True, fused_kernels=fused, **kw)


def linear_op(module, dev):
    """v -> R(v) - R(0) of `module` on its single instance."""
    inputs, frc = (torch.from_numpy(a)[None].to(dev)
                   for a in module.dataset[0])
    module.to(dev)
    b0 = module.residual_for_field(torch.zeros_like(inputs[..., 0]),
                                   inputs, frc)[0]

    def A(v):
        return module.residual_for_field(v[None], inputs, frc)[0] - b0
    return A


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain-size", type=int, default=64)
    p.add_argument("--loss-type", default="resmin",
                   choices=["energy", "resmin", "strong"])
    p.add_argument("--optimizer", default="lbfgs",
                   choices=["adam", "sgd", "lbfgs", "cg", "mg-cg"],
                   help="cg / mg-cg = direct matrix-free Krylov solve of "
                        "the linear system (train.linear), no training "
                        "loop; mg-cg adds the geometric-multigrid V-cycle "
                        "preconditioner (needs n = 2^k + 1)")
    p.add_argument("--fem-basis-deg", type=int, default=1)
    p.add_argument("--max-epochs", type=int, default=80)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--fast-dev-run", action="store_true")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..train import Trainer, make_run_dir
    from ..utils import write_vti

    dev = device_of(args, "poisson_mms_2d")
    n = args.domain_size
    if args.loss_type == "strong" and args.fem_basis_deg < 2:
        args.fem_basis_deg = 2
    if (n - 1) % args.fem_basis_deg:
        n += args.fem_basis_deg - (n - 1) % args.fem_basis_deg
        print(f"adjusted domain size to {n} "
              f"((size-1) % deg == 0 required)")
    module = mms_module(n, args.fem_basis_deg, args.loss_type,
                        args.fused_kernels,
                        learning_rate=args.learning_rate)
    run_dir = make_run_dir(args.out_dir, f"poisson-mms-{args.loss_type}")
    solve_s = None
    if args.optimizer in ("cg", "mg-cg"):
        from ..train import module_linear_solve, multigrid_preconditioner

        M = None
        if args.optimizer == "mg-cg":
            if (n - 1) & (n - 2):
                p.error(f"--optimizer mg-cg needs a 2^k + 1 grid "
                        f"(got {n}); try 65 or 129")

            def factory(nn_):
                return mms_module(nn_, args.fem_basis_deg, "resmin",
                                  init=False)

            # with the kernels, the fine level's operator is the fused
            # module's (K1); the setup probes the factory's, its equal
            fine = linear_op(module, dev) if args.fused_kernels else None
            M, _ = multigrid_preconditioner(factory, n, fine_matvec=fine,
                                            device=dev)
        t0 = time.perf_counter()
        u, _ = module_linear_solve(module, tol=1e-10, M=M, device=dev)
        solve_s = time.perf_counter() - t0
        u = torch.from_numpy(u).to(dev)
    else:
        trainer = Trainer(max_epochs=args.max_epochs,
                          optimizer=args.optimizer,
                          learning_rate=args.learning_rate, run_dir=run_dir,
                          checkpoint=True, fast_dev_run=args.fast_dev_run,
                          device=dev)
        trainer.fit(module)
        with torch.no_grad():
            u = module.network()[0]
    with torch.no_grad():
        eL2, uL2, uexL2 = module.calc_l2_err(u, verbose=True)
    u = host(u)
    x = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(x, x)
    save_contours(os.path.join(run_dir, "contours.png"),
                  {"u": u, "u_exact": exact(xx, yy),
                   "error": u - exact(xx, yy)})
    write_vti(os.path.join(run_dir, "u.vti"), u)
    rel = float(eL2 / uexL2)
    print(f"run_dir: {run_dir}  rel_L2: {rel:.3e}")
    return {"run_dir": run_dir, "rel_l2": rel, "u": u, "solve_s": solve_s}


if __name__ == "__main__":
    main()
