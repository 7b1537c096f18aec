"""diffnet_tpu_torch: the PyTorch / CUDA port of diffnet_tpu.

It sits beside the JAX package and imports torch, numpy and scipy only,
never jax or ``diffnet_tpu``. Subpackages keep the JAX package's names:
``core`` (basis tables, FEM evaluation and assembly), ``ops`` (hand-written
CUDA kernels for Hopper, each with its plain torch version), ``pde``
(Poisson, IBN, flow), ``models`` (``DirectField``, the conv networks and
pointnets), ``data`` (2D and 3D datasets, the KL-sum generator and the
loader), ``train`` (``Trainer``; stencil extraction, Krylov solvers and
the multigrid-preconditioned linear solve; queries; pretraining),
``config`` (run configuration) and ``utils`` (the host library's binding,
ILU factors, the VTI writer, meshes, export, device resolution). Every entry
point runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
