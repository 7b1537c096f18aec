"""K2: the resmin loss and its u-gradient in one launch.

Replaces the TPU kernel ``diffnet_tpu/ops/poisson_loss_grad.py``
(``_loss_grad_impl``, body ``_kernel_lg``). For the Galerkin
residual-minimisation loss

    L = sum R^2,   R = where(bc > 0.5, 0, K(nu) u - Nf),

K is self-adjoint and R already carries the mask's zeros, so
dL/du = 2 K(nu) R. Both R and K(R) are one-element-halo stencils, so one
pass with a 2-node halo gives the loss and the gradient.

The mask is a ``where``, as in every other resmin path of the JAX package;
its TPU kernel multiplies by ``1 - bc`` instead. The two agree on binary
masks; with a fractional mask this op follows the XLA path
(``poisson_resmin_residual_et``).

What bounds it on the card: bytes, in principle. It moves u, nu, Nf and bc
in and the gradient out, 20 B a node (about 168 MB at 512^2, batch 32). The
kernel (``csrc/poisson2d.cu::loss_grad_kernel``) gives each 16x16 tile of
output nodes one block: it stages u and nu with a 2-node halo in shared memory,
forms R on the tile plus a 1-node halo there (R never goes to device
memory), writes 2 K(nu) R for the tile and one partial of sum R^2 over the
nodes it owns. The partials are summed outside the kernel, in a fixed
order, so every run gives the same loss. Each owned node costs about nine
element bodies (R on the tile plus halo, then K(R)), so this first design
is bound by instruction issue: 0.25 ms at 512^2 x 32 on an H100 (700 W),
about a fifth of peak bandwidth (PERF.md).

The forward returns the loss and keeps the gradient: a training step costs
this one launch plus the optimizer update. The nu and Nf cotangents are
computed in the backward only when asked for.
"""

from __future__ import annotations

import torch

from ..core import fem
from ._build import check, load_library
from .poisson_residual import (assemble_corners, check_fields,
                               element_contributions, nu_projection,
                               poisson_residual_fused, require_cuda,
                               stiffness_consts)

__all__ = ["poisson_resmin_loss_fused", "resmin_loss_grad",
           "resmin_loss_grad_plain"]

# Launches of the CUDA kernel (a plain count; callers reset it to 0).
launches = 0


def resmin_loss_grad_plain(u, nu, Nf, bc_mask, basis: fem.BasisTables):
    """Plain torch (loss, grad) on any device: the kernel's reference."""
    k = stiffness_consts(basis.basis)
    Ku = assemble_corners(*element_contributions(u, nu, k))
    R = torch.where(bc_mask > 0.5, torch.zeros_like(Ku), Ku - Nf)
    grad = 2.0 * assemble_corners(*element_contributions(R, nu, k))
    return torch.sum(R * R), grad


def _check_plane(name: str, t: torch.Tensor, u: torch.Tensor) -> None:
    """`t` is one ``[ny, nx]`` plane for the whole batch or ``[B, ny, nx]``."""
    if t.shape not in (u.shape, u.shape[1:]):
        raise ValueError(f"{name}.shape {tuple(t.shape)} must be "
                         f"{tuple(u.shape[1:])} or {tuple(u.shape)}")
    if t.dtype != torch.float32 or t.device != u.device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on "
                         "u's device")


def resmin_loss_grad(u, nu, Nf, bc_mask, basis: fem.BasisTables):
    """(sum R^2, 2 K(nu) R): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; any other device raises. `Nf` and `bc_mask`
    are ``[ny, nx]`` (shared by the batch) or ``[B, ny, nx]``."""
    global launches
    check_fields("poisson_resmin_loss_fused", u, nu=nu)
    _check_plane("Nf", Nf, u)
    _check_plane("bc_mask", bc_mask, u)
    if u.device.type == "cpu":
        return resmin_loss_grad_plain(u, nu, Nf, bc_mask, basis)
    require_cuda("poisson_resmin_loss_fused", u)
    lib = load_library()
    B, ny, nx = u.shape
    grad = torch.empty_like(u)
    partials = torch.empty(lib.poisson_resmin_loss_grad_partials(B, ny, nx),
                           dtype=u.dtype, device=u.device)
    status = lib.poisson_resmin_loss_grad(
        u.data_ptr(), nu.data_ptr(), Nf.data_ptr(),
        ny * nx if Nf.dim() == 3 else 0, bc_mask.data_ptr(),
        ny * nx if bc_mask.dim() == 3 else 0, grad.data_ptr(),
        partials.data_ptr(), B, ny, nx, *stiffness_consts(basis.basis),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "poisson_resmin_loss_fused")
    launches += 1
    return partials.sum(), grad


class _ResminLossGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, nu, Nf, bc_mask, basis):
        loss, grad = resmin_loss_grad(u, nu, Nf, bc_mask, basis)
        ctx.basis = basis
        ctx.save_for_backward(grad, u, nu, Nf, bc_mask)
        return loss

    @staticmethod
    def backward(ctx, g):
        grad, u, nu, Nf, bc_mask = ctx.saved_tensors
        du = g * grad if ctx.needs_input_grad[0] else None
        dnu = dNf = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # field training differentiates u only; the rest is recomputed
            # here, and only when asked for
            with torch.no_grad():
                R = poisson_residual_fused(u, nu, Nf, bc_mask, ctx.basis)
            if ctx.needs_input_grad[1]:
                dnu = 2.0 * g * nu_projection(u, R, ctx.basis)
            if ctx.needs_input_grad[2]:
                dNf = -2.0 * g * R
                if Nf.dim() == 2:
                    dNf = dNf.sum(0)
        return du, dnu, dNf, None, None


def poisson_resmin_loss_fused(u, nu, Nf, bc_mask, basis: fem.BasisTables):
    """``sum(R^2)`` with ``R = where(bc_mask > 0.5, 0, K(nu) u - Nf)``; loss
    and u-gradient in one kernel launch. `Nf` and `bc_mask` may be
    ``[ny, nx]`` or ``[B, ny, nx]``; `bc_mask` gets no gradient."""
    return _ResminLossGrad.apply(u, nu, Nf, bc_mask, basis)
