"""3D Poisson: MMS cube or solve-on-voxelized-object (port of
``examples/poisson_3d.py``) — counterpart of
examples/poisson/single_instance/{9_voxel_3d,e19_solve_on_object_3d}.py and
tests/test3D.py.

    python -m diffnet_tpu_torch.examples.poisson_3d --domain-size 17 \
        --fused-kernels
    python -m diffnet_tpu_torch.examples.poisson_3d \
        --voxel-prefix path/to/Hand   # *.raw object

With ``--fused-kernels`` the MMS cube's resmin runs K5
(``csrc/poisson3d.cu``); the voxel object's energy has no fused path and
raises.
"""

import argparse
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain-size", type=int, default=17)
    p.add_argument("--max-epochs", type=int, default=60)
    p.add_argument("--voxel-prefix", default=None,
                   help="prefix of <prefix>inouts.raw + "
                        "<prefix>VoxelConfig.txt")
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)

    from ..data.single_instances import CuboidManufactured, VoxelIMBackRAW
    from ..models import DirectField
    from ..pde import Poisson3D
    from ..train import Trainer, make_run_dir
    from ..utils import write_vti

    dev = device_of(args, "poisson_3d")
    n = args.domain_size
    run_dir = make_run_dir(args.out_dir, "poisson-3d")
    if args.voxel_prefix:
        # reference embedding default is 64^3 (voxels.py); honor a LARGER
        # explicit --domain-size, never silently shrink below it
        n = max(args.domain_size, 64)
        ds = VoxelIMBackRAW(args.voxel_prefix, domain_size=n)
        ds.n_samples = 1
        net = DirectField((n, n, n), init=np.zeros((n, n, n)))
        module = Poisson3D(net, ds, domain_size=n, batch_size=1,
                           loss_type="energy",
                           fused_kernels=args.fused_kernels)
    else:
        ds = CuboidManufactured(domain_size=n)
        ds.n_samples = 1
        net = DirectField((n, n, n), init=np.zeros((n, n, n)))
        module = Poisson3D(net, ds, domain_size=n, batch_size=1,
                           loss_type="resmin", exact_solution=ds.exact,
                           forcing=ds.forcing_func, mms_dirichlet=True,
                           fused_kernels=args.fused_kernels)
    trainer = Trainer(max_epochs=args.max_epochs, optimizer="lbfgs",
                      lbfgs_max_iter=10, run_dir=run_dir, checkpoint=True,
                      device=dev)
    trainer.fit(module)
    with torch.no_grad():
        u = module.network()[0]
    write_vti(os.path.join(run_dir, "u3d.vti"), host(u))
    out = {"run_dir": run_dir, "u": host(u)}
    if args.voxel_prefix:
        # chi isosurface -> OBJ (the reference marching-cubes + trimesh
        # workflow, IBN_3D.py:36-69)
        from ..utils.mesh3d import field_to_obj

        chi = ds[0][0][..., 1]
        field_to_obj(os.path.join(run_dir, "object.obj"), chi, level=0.5)
    else:
        with torch.no_grad():
            eL2, _, uexL2 = module.calc_l2_err(u, verbose=True)
        out["rel_l2"] = float(eL2 / uexL2)
        print(f"rel_L2: {out['rel_l2']:.3e}")
    print(f"run_dir: {run_dir}")
    return out


if __name__ == "__main__":
    main()
