"""Stokes MMS with PSPG (port of ``examples/stokes_mms.py``) —
counterpart of examples/stokes/single_instance/e1_stokes_mms_resmin.py.

    python -m diffnet_tpu_torch.examples.stokes_mms --domain-size 32 \
        --max-epochs 300
    python -m diffnet_tpu_torch.examples.stokes_mms --domain-size 33 \
        --solver gmres

No kernel fuses the Stokes residual: ``--fused-kernels`` raises in the
module.
"""

import argparse
import math
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, save_contours


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--max-epochs", type=int, default=300)
    p.add_argument("--solver", choices=("lbfgs", "gmres"), default="lbfgs",
                   help="lbfgs: reference-style residual-norm descent; "
                        "gmres: block-preconditioned Krylov solve of the "
                        "mixed system (train.linear.stokes_linear_solve)")
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..data.flow import StokesMMSDataset
    from ..models import DirectField
    from ..pde import StokesMMS
    from ..train import Trainer, make_run_dir

    dev = device_of(args, "stokes_mms")
    n = args.domain_size
    ds = StokesMMSDataset(domain_size=n)
    ds.n_samples = 1
    module = StokesMMS(
        DirectField((n, n), init=np.zeros((n, n)), n_fields=3), ds,
        domain_size=n, batch_size=1, Re=1, loss_norm="squared",
        fused_kernels=args.fused_kernels)
    run_dir = make_run_dir(args.out_dir, "stokes-mms")
    inputs = torch.from_numpy(ds[0][0])[None].to(dev)
    if args.solver == "gmres":
        from ..train import stokes_linear_solve

        (u, v, pr), _ = stokes_linear_solve(module, device=dev)
    else:
        trainer = Trainer(max_epochs=args.max_epochs, optimizer="lbfgs",
                          lbfgs_max_iter=10, run_dir=run_dir,
                          checkpoint=True, device=dev)
        trainer.fit(module)
        with torch.no_grad():
            u, v, pr = (host(a)[0] for a in module.apply_bcs(
                module.network(inputs), inputs))
    module.to(dev)
    with torch.no_grad():
        jxw = module.jxw_c()
        ugp = module.gauss_pt_evaluation(torch.from_numpy(u).to(dev))
        ex = torch.from_numpy(np.sin(math.pi * module.xgp) * np.cos(
            math.pi * module.ygp)).to(ugp)
        rel = float(torch.sqrt(torch.sum((ugp - ex) ** 2 * jxw))
                    / torch.sqrt(torch.sum(ex ** 2 * jxw)))
    save_contours(os.path.join(run_dir, "uvp.png"),
                  {"u": u, "v": v, "p": pr})
    print(f"run_dir: {run_dir}  u rel_L2: {rel:.3e}")
    return {"run_dir": run_dir, "u_rel_l2": rel, "u": u, "v": v, "p": pr}


if __name__ == "__main__":
    main()
