"""Multi-device work over ``torch.distributed`` (port of
``diffnet_tpu/parallel``): process meshes with data-parallel batches and
row-sharded fields (``mesh``), the spatially sharded Poisson stiffness
actions through K1 and K5 (``spatial``), spawning a process group
(``launch``), the four-workload dry run (``dryrun``) and the torchrun
scaling demo (``scaling``).
"""

from .launch import rank_device, run_ranks
from .mesh import (Mesh, all_reduce_sum, block_bounds, block_lengths,
                   gather_block, halo_exchange,
                   halo_exchange_transpose, halo_exchange_y, halo_exchange_z,
                   local_block, make_mesh, replicate, shard_batch,
                   spatial_mesh)
from .spatial import (poisson_residual_spatial,
                      poisson_stiffness_spatial_fused,
                      poisson_stiffness_spatial_fused_3d)

__all__ = ["Mesh", "make_mesh", "shard_batch", "block_bounds",
           "block_lengths", "local_block", "gather_block", "spatial_mesh",
           "replicate", "all_reduce_sum", "halo_exchange",
           "halo_exchange_transpose",
           "halo_exchange_y", "halo_exchange_z", "poisson_residual_spatial",
           "poisson_stiffness_spatial_fused",
           "poisson_stiffness_spatial_fused_3d", "run_ranks", "rank_device"]
