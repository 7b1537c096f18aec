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
kernel (``csrc/poisson2d.cu::loss_grad_kernel``) gives each warp 61 output
node columns and ``strip_rows`` rows. A lane holds three node columns of u
and nu, loaded straight from device memory a row at a time, and walks down
the rows: it computes each element of R's tile-plus-halo once (the bottom
corner sums carried in registers, the neighbour's by shuffle), masks and
subtracts Nf on the fly, and one row behind runs the same walk over R to
write 2 K(nu) R; R never leaves registers. Each warp writes one partial of
sum R^2 over the nodes it owns; the partials are summed outside the
kernel, in a fixed order, so every run gives the same loss. That is about
2.2 element bodies a node, where the first design (a block a 16x16 tile,
gather form) spent about nine: 0.093 ms at 512^2 x 32 on an H100 (700 W),
from 0.224, still bound by instruction issue (its byte bound is 0.040 ms;
PERF.md).

The forward returns the loss and keeps the gradient: a training step costs
this one launch plus the optimizer update. The nu and Nf cotangents are
computed in the backward only when asked for.
"""

from __future__ import annotations

import torch

from ..core import fem
from ._build import check, load_library, sm_count
from .poisson_residual import (assemble_corners, check_fields,
                               element_contributions, longest_strip,
                               nu_projection, poisson_residual_fused,
                               require_cuda, stiffness_consts)

__all__ = ["poisson_resmin_loss_fused", "resmin_loss_grad",
           "resmin_loss_grad_plain"]

# Launches of the CUDA kernel (a plain count; callers reset it to 0).
launches = 0

# The kernel's tiling (csrc/poisson2d.cu): a warp owns COLS output node
# columns and a strip of node rows, one of STRIPS long (the kernel takes 1
# to 64); a strip of ty rows computes (ty + 3) rows of R's elements and
# (ty + 1) of the gradient's, so longer strips waste less, as long as the
# launch still gives the SMs their warps. On an H100, 32 and 16 rows tie at
# 512^2 x 32 (8 rows 9% slower), 4 rows is fastest at 1 x 513^2 and 8 at
# 8 x 256^2, both ~9 warps an SM (PERF.md).
COLS = 61
STRIPS = (32, 16, 8, 4, 2, 1)
MIN_WARPS_PER_SM = 8


def strip_rows(B: int, ny: int, nx: int, sms: int) -> int:
    """Node rows of a K2 tile for a ``[B, ny, nx]`` launch on `sms` SMs:
    the longest strip whose launch still gives each SM
    ``MIN_WARPS_PER_SM`` warps, else the shortest."""
    return longest_strip(B * -(-nx // COLS), ny, STRIPS, MIN_WARPS_PER_SM,
                         sms)


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
    out = loss_grad_at_strip(u, nu, Nf, bc_mask, basis,
                             strip_rows(*u.shape, sm_count(u.device)))
    launches += 1
    return out


def loss_grad_at_strip(u, nu, Nf, bc_mask, basis: fem.BasisTables,
                       ty: int):
    """One launch of the CUDA kernel at tile height `ty` on checked CUDA
    tensors (not counted in ``launches``): the wrapper's launch, and the
    card checks' of every strip."""
    if u[0].numel() > 2**31 - 64:
        raise ValueError("poisson_resmin_loss_fused: a sample's nodes must "
                         "fit in 31 bits (the kernel's offsets)")
    lib = load_library()
    B, ny, nx = u.shape
    grad = torch.empty_like(u)
    partials = torch.empty(
        lib.poisson_resmin_loss_grad_partials(B, ny, nx, ty),
        dtype=u.dtype, device=u.device)
    status = lib.poisson_resmin_loss_grad(
        u.data_ptr(), nu.data_ptr(), Nf.data_ptr(),
        ny * nx if Nf.dim() == 3 else 0, bc_mask.data_ptr(),
        ny * nx if bc_mask.dim() == 3 else 0, grad.data_ptr(),
        partials.data_ptr(), B, ny, nx, ty, *stiffness_consts(basis.basis),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "poisson_resmin_loss_fused")
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
