"""Signed-distance reconstruction from an oriented point cloud (port of
``examples/eikonal_reconstruction.py``) — counterpart of
examples/eiqonal/single_instance/e01_curve_reconstruction.py (2D) and
05_3d_sphere_loss4.py / 04_3d_sphere_recon.py (3D; --nsd 3).

    python -m diffnet_tpu_torch.examples.eikonal_reconstruction \
        --domain-size 32
    python -m diffnet_tpu_torch.examples.eikonal_reconstruction --nsd 3 \
        --domain-size 33
    python -m diffnet_tpu_torch.examples.eikonal_reconstruction \
        --domain-size 64 --solver gn

The eikonal losses have no fused kernel: ``--fused-kernels`` is refused.
"""

import argparse
import os

import numpy as np
import torch

from ._common import add_port_flags, device_of, host, no_kernel, \
    save_contours


def _load_voxel_cloud(path, max_points):
    """Oriented cloud from a voxel asset: .npz with a 3D binary array, or
    a .zip containing one (the reference stanford-bunny.zip layout)."""
    import io
    import zipfile

    from ..core.geometry import cloud_from_voxels

    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            name = next(n for n in z.namelist() if n.endswith(".npz"))
            d = np.load(io.BytesIO(z.read(name)))
    else:
        d = np.load(path)
    vox = d[d.files[0]]
    return cloud_from_voxels(vox, max_points=max_points)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nsd", type=int, default=2, choices=(2, 3))
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--max-epochs", type=int, default=300)
    p.add_argument("--solver", choices=("lbfgs", "gn"), default="lbfgs",
                   help="lbfgs: reference-style descent; gn: matrix-free "
                        "Gauss-Newton on the eikonal least-squares system "
                        "(seconds instead of hundreds of epochs)")
    p.add_argument("--xyzna", default=None,
                   help="optional .xyzna cloud file (2D: z ignored)")
    p.add_argument("--voxels", default=None,
                   help="3D only: voxel occupancy .npz or .zip (e.g. the "
                        "reference stanford-bunny.zip); default is a "
                        "synthetic sphere cloud")
    p.add_argument("--max-points", type=int, default=2500)
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)
    no_kernel(p, args, "the eikonal loss")

    from ..core.geometry import sample_ellipse_cloud, sample_sphere_cloud
    from ..data import InMemoryDataset, NumpyLoader
    from ..models import DirectField
    from ..pde import Eikonal2D, Eikonal3D, signed_occupancy_init
    from ..train import Trainer, make_run_dir
    from ..utils import read_xyzna

    dev = device_of(args, "eikonal_reconstruction")
    n = args.domain_size
    if args.nsd == 3:
        if args.voxels:
            pts, nrm, area = _load_voxel_cloud(args.voxels, args.max_points)
        elif args.xyzna:
            pts, nrm, area = read_xyzna(args.xyzna)
            if not area.any():
                # estimate per-point area from local spacing: for a
                # roughly uniform sampling of a surface, each point
                # covers ~ d_nn^2 (d_nn = nearest-neighbor distance).
                # A fixed total of 1.0 would mis-scale the winding
                # integral for surfaces whose true area differs from 1
                # and break the occupancy sign initialization.
                from scipy.spatial import cKDTree

                d_nn, _ = cKDTree(pts).query(pts, k=2)
                area = (d_nn[:, 1] ** 2).astype(np.float32)
        else:
            pts, nrm, area = sample_sphere_cloud(n_points=2000, radius=0.25)
        grid = (n, n, n)
        module_cls = Eikonal3D
    else:
        if args.xyzna:
            pts3, nrm3, area = read_xyzna(args.xyzna)
            pts, nrm = pts3[:, :2], nrm3[:, :2]
            if not area.any():
                d = np.linalg.norm(np.roll(pts, -1, 0) - pts, axis=-1)
                area = 0.5 * (d + np.roll(d, 1, 0))
        else:
            pts, nrm, area = sample_ellipse_cloud(n_points=150,
                                                  center=(0.5, 0.5),
                                                  radii=(0.28, 0.18))
        grid = (n, n)
        module_cls = Eikonal2D
    cloud = np.concatenate([pts, nrm, area[:, None]], -1).astype(np.float32)
    ds = InMemoryDataset(cloud[None],
                         np.zeros((1,) + grid + (1,), np.float32))

    u0 = signed_occupancy_init(
        *(torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]
          for a in (pts, nrm, area)), grid)[0]
    net = DirectField(grid, init=host(u0))
    module = module_cls(net, ds, domain_size=n, batch_size=1,
                        sdf_weight=100.0, normals_weight=10.0)

    run_dir = make_run_dir(args.out_dir, f"eikonal{args.nsd}d")
    out = {"run_dir": run_dir}
    if args.solver == "gn":
        from ..pde import eikonal_gn_residual
        from ..train import gauss_newton_solve

        r = eikonal_gn_residual(module, cloud[None], device=dev)
        x, info = gauss_newton_solve(r, u0, newton_iters=40, cg_iters=100,
                                     lm=1e-4, device=dev)
        out.update(gn_iters=info["gn_iters"],
                   final_loss=info["loss_history"][-1])
        print(f"gauss-newton iters: {info['gn_iters']}  "
              f"loss: {info['loss_history'][-1]:.3e}")
        u = host(x)
    else:
        trainer = Trainer(max_epochs=args.max_epochs, optimizer="lbfgs",
                          lbfgs_max_iter=10, run_dir=run_dir,
                          checkpoint=True, device=dev)
        trainer.fit(module, NumpyLoader(ds, batch_size=1, device=dev))
        with torch.no_grad():
            u = host(net()[0])
    u0 = host(u0)
    out["u"] = u
    if args.nsd == 3:
        # zero-isosurface OBJ (reference exports the 3D result through
        # marching-cubes + trimesh, IBN_3D.py:36-69)
        from ..utils.mesh3d import field_to_obj

        h = 1.0 / (n - 1)
        obj = os.path.join(run_dir, "surface.obj")
        field_to_obj(obj, u, level=0.0, spacing=(h, h, h))
        save_contours(os.path.join(run_dir, "sdf.png"),
                      {"initial z-mid": u0[n // 2], "sdf z-mid": u[n // 2]})
        print(f"run_dir: {run_dir}  exported {obj}  "
              f"sdf range [{u.min():.3f}, {u.max():.3f}]")
    else:
        save_contours(os.path.join(run_dir, "sdf.png"),
                      {"initial": u0, "sdf": u, "|sdf|<h band":
                       (np.abs(u) < 1.0 / n).astype(float)})
        print(f"run_dir: {run_dir}  sdf range [{u.min():.3f}, {u.max():.3f}]")
    return out


if __name__ == "__main__":
    main()
