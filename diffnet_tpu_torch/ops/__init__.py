"""Hand-written CUDA kernels for Hopper, each with its plain torch version.

Every op module holds the kernel's wrapper (the kernel for CUDA tensors,
the plain version for CPU tensors), the plain version, a
``torch.autograd.Function`` and a ``launches`` count. The kernels live in
``diffnet_tpu_torch/csrc/`` and are built at first use (``_build.py``).
"""

from .ns_residual import ns_vms_residual_fused
from .poisson_energy import poisson_energy_fused
from .poisson_loss_grad import poisson_resmin_loss_fused
from .poisson_residual import poisson_residual_fused, poisson_stiffness_action
from .poisson_residual_3d import (poisson_residual_fused_3d,
                                  poisson_stiffness_action_3d)
# (``stencil_apply`` itself stays under its module's name, which it shares)
from .stencil_apply import (stencil_apply_2d, stencil_apply_3d,
                            stencil_transpose_planes)

__all__ = ["poisson_stiffness_action", "poisson_residual_fused",
           "poisson_stiffness_action_3d", "poisson_residual_fused_3d",
           "poisson_resmin_loss_fused", "poisson_energy_fused",
           "stencil_apply_2d", "stencil_apply_3d",
           "stencil_transpose_planes", "ns_vms_residual_fused"]
