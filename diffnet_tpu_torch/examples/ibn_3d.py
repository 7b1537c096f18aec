"""3D parametric IBN training (port of ``examples/ibn_3d.py``) —
counterpart of the reference DDP flagship
IBN/poisson-3d/parametric/IBN_3D.py (32^3 voxel/topology ensembles, UNet3D,
2-GPU DDP). ``--data-devices N`` trains data-parallel: N spawned ranks of
one process group (``parallel.launch.run_ranks``; NCCL with a card a rank,
else gloo, the ranks then sharing the one device), each taking its rows of
every global batch, the gradients all-reduced by the Trainer.

    python -m diffnet_tpu_torch.examples.ibn_3d --domain-size 32 \
        --batch-size 8 --max-epochs 10
    python -m diffnet_tpu_torch.examples.ibn_3d --data-devices 2

The IBN energy has no fused kernel: ``--fused-kernels`` is refused.
"""

import argparse
import os

import torch

from ._common import add_port_flags, device_of, host, no_kernel


def train(rank, world, args, run_dir):
    """Build and fit the model (on this rank's rows of every batch when
    `world` > 1); rank 0 exports one solved field and the object's
    isosurface and returns what ``main`` returns."""
    from ..data import NumpyLoader
    from ..data.geometry_datasets import TopoDataset3D, synthesize_topology_3d
    from ..models import UNet3D
    from ..pde import IBNPoisson3D
    from ..train import Trainer
    from ..utils import write_vti
    from ..utils.mesh3d import field_to_obj

    mesh = dev = None
    if world > 1:
        import torch.distributed as dist

        from ..parallel import make_mesh
        from ..parallel.launch import rank_device

        mesh = make_mesh(data=world)
        dev = rank_device(dist.get_backend(), args.device)
        if rank == 0:
            print(f"data-parallel mesh: {world} ranks "
                  f"({dist.get_backend()})")
    else:
        dev = device_of(args, "ibn_3d")
    n = args.domain_size
    if args.topo_dir:
        ds = TopoDataset3D(args.topo_dir, domain_size=n)
    else:
        ds = TopoDataset3D([synthesize_topology_3d(n=n, seed=s)
                            for s in range(args.n_samples)], domain_size=n)
    loader = NumpyLoader(ds, batch_size=args.batch_size, shuffle=True,
                         device=dev, mesh=mesh)
    net = UNet3D(3, 1, base_filters=4)
    module = IBNPoisson3D(net, domain_size=n, batch_size=args.batch_size,
                          learning_rate=1e-3)
    trainer = Trainer(max_epochs=args.max_epochs, optimizer="adam",
                      learning_rate=1e-3, run_dir=run_dir, checkpoint=True,
                      device=dev)
    trainer.fit(module, loader)
    if rank != 0:
        return None

    # export one solved field + the object isosurface (reference IBN_3D
    # marching-cubes visualization, IBN_3D.py:36-69)
    batch = next(iter(loader))
    with torch.no_grad():
        u, inputs, _ = module(batch)
        u = host(module.apply_bcs(u, inputs))[0]
    write_vti(os.path.join(run_dir, "u.vti"), u)
    field_to_obj(os.path.join(run_dir, "object.obj"),
                 host(batch[0][0, ..., 1]), level=0.5)
    return {"run_dir": run_dir, "u": u, "world": world,
            "losses": list(trainer.step_losses),
            # numpy: a tensor returned from a rank would travel through
            # torch's shared-memory pickling
            "params": {k: host(v).copy() for k, v in
                       net.state_dict().items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain-size", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--n-samples", type=int, default=16)
    p.add_argument("--max-epochs", type=int, default=10)
    p.add_argument("--topo-dir", default=None,
                   help="dir of npz topology files; synthetic bar lattices "
                        "when omitted")
    p.add_argument("--data-devices", type=int, default=0,
                   help=">0: train data-parallel over this many ranks")
    p.add_argument("--out-dir", default="runs")
    add_port_flags(p)
    args = p.parse_args(argv)
    no_kernel(p, args, "the IBN energy")
    if args.data_devices and args.batch_size % args.data_devices:
        p.error(f"--batch-size {args.batch_size} must be divisible by "
                f"--data-devices {args.data_devices} (data sharding)")
    device_of(args, "ibn_3d")

    from ..train import make_run_dir

    run_dir = make_run_dir(args.out_dir, "ibn-3d")
    if args.data_devices > 1:
        from ..parallel.launch import run_ranks

        cuda = torch.device(args.device).type == "cuda"
        backend = ("nccl" if cuda and torch.cuda.device_count()
                   >= args.data_devices else "gloo")
        out = run_ranks(train, args.data_devices, (args, run_dir),
                        backend=backend, timeout=3600.0,
                        threads=None if cuda else 1)[0]
    else:
        out = train(0, 1, args, run_dir)
    print(f"run_dir: {run_dir}")
    return out


if __name__ == "__main__":
    main()
