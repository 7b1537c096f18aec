"""K3: the Ritz energy of deg-1 2D Poisson.

Replaces the TPU kernel ``diffnet_tpu/ops/poisson_energy.py``
(``_energy_fwd_impl``, body ``_kernel``):

    E = mean_{b, e} sum_gp JxW * (0.5 * nu |grad u|^2 - u f)

with u, nu and f nodal ``[B, ny, nx]`` fields evaluated at the 2x2 Gauss
points through the Q1 basis. The element body is the sum-factorised algebra
of the JAX kernel (exact; ~61 flops an element).

What bounds it on the card: bytes. It moves u, nu and f in, 12 B a node
(about 101 MB at 512^2, batch 32), and one float per warp out. The kernel
(``csrc/poisson2d.cu::energy_kernel``) gives each warp 64 element columns
and ``strip_rows`` element rows: a lane computes two elements a row, once
each, from its nodes of the row above (kept in registers) and the row
below (loaded straight from device memory, the next row's loads issued
before this row's bodies), and keeps its sum in a register; one shuffle
tree gives the warp's partial. The partials are summed outside the kernel,
in a fixed order, and divided by ``B * nely * nelx``. 0.045 ms at 512^2 x
32 on an H100 (700 W), 67% of its byte bound, from 0.069 for the first
design (a thread an element, each node loaded four times); bf16 0.044
(PERF.md).

The gradient reuses K1: dE/du = (K(nu) u - Nf) / (B nely nelx) is the
assembled Galerkin residual, so the backward runs the stiffness kernel; the
nu and f cotangents are Galerkin projections.

u, nu and f are all float32 or all bfloat16, as the JAX kernel's fields may
be; the energy has their type. The bfloat16 kernel loads the narrow type
and sums in float32 registers and partials, rounding once at the end (the
plain version upcasts, computes and casts back); its backward runs the
stiffness kernel in the fields' type and the projections in float32.

The JAX kernel takes square fields only; this one takes rectangular fields
too, with the mean over all elements as in the XLA path
(``poisson_energy_loss``).
"""

from __future__ import annotations

import torch

from ..core import fem
from ..core.quadrature import FEMBasis
from ._build import check, load_library, sm_count
from .poisson_residual import (FIELD_TYPES, check_fields, longest_strip,
                               q1_geometry, require_cuda, stiffness_action)

__all__ = ["poisson_energy_fused", "energy", "energy_plain"]

# Launches of the CUDA kernel (a plain count; callers reset it to 0).
launches = 0

# The kernel's tiling (csrc/poisson2d.cu): a warp owns COLS element columns
# and a strip of element rows, one of STRIPS long (the kernel takes 1 to
# 64); a strip of ty rows reads (ty + 1) node rows. On an H100, 32 rows is
# fastest at 512^2 x 32 in float32, and ~8-16 warps an SM at 1 x 513^2 and
# 8 x 256^2 (2 and 4 rows) (PERF.md).
COLS = 64
STRIPS = (32, 16, 8, 4, 2, 1)
MIN_WARPS_PER_SM = 8


def strip_rows(B: int, ny: int, nx: int, sms: int) -> int:
    """Element rows of a K3 tile for a ``[B, ny, nx]`` launch on `sms` SMs:
    the longest strip whose launch still gives each SM
    ``MIN_WARPS_PER_SM`` warps, else the shortest."""
    return longest_strip(B * -(-(nx - 1) // COLS), ny - 1, STRIPS,
                         MIN_WARPS_PER_SM, sms)


def energy_consts(basis: FEMBasis) -> tuple[float, ...]:
    """Folded constants (c1x, c2x, c3x, c1y, c2y, c3y, cm) of the
    sum-factorised energy body: c1 = W/(8 h^2), c2 = d2 c1, c3 = 2 d2 c1 per
    axis, and cm = W/9 for the load term (d2 and W as in
    :func:`q1_geometry`)."""
    d2, W, hx, hy = q1_geometry(basis)
    c1x, c1y = W / (8.0 * hx * hx), W / (8.0 * hy * hy)
    return (c1x, d2 * c1x, 2.0 * d2 * c1x,
            c1y, d2 * c1y, 2.0 * d2 * c1y, W / 9.0)


def element_energy(u, nu, f, c) -> torch.Tensor:
    """Per-element energy ``[B, ny-1, nx-1]``: the plain torch form of the
    kernel's body."""
    c1x, c2x, c3x, c1y, c2y, c3y, cm = c
    c00, c01 = u[..., :-1, :-1], u[..., :-1, 1:]
    c10, c11 = u[..., 1:, :-1], u[..., 1:, 1:]
    n00, n01 = nu[..., :-1, :-1], nu[..., :-1, 1:]
    n10, n11 = nu[..., 1:, :-1], nu[..., 1:, 1:]
    f00, f01 = f[..., :-1, :-1], f[..., :-1, 1:]
    f10, f11 = f[..., 1:, :-1], f[..., 1:, 1:]
    dxl, dxh = c01 - c00, c11 - c10
    dyl, dyh = c10 - c00, c11 - c01
    sxr0, sxr1 = n00 + n01, n10 + n11
    syc0, syc1 = n00 + n10, n01 + n11
    nsum = sxr0 + sxr1
    Xx, Xy = sxr0 - sxr1, syc0 - syc1
    Ux, Vx = dxl + dxh, dxl - dxh
    Uy, Vy = dyl + dyh, dyl - dyh
    ex = nsum * (c1x * (Ux * Ux) + c2x * (Vx * Vx)) + c3x * (Ux * Vx) * Xx
    ey = nsum * (c1y * (Uy * Uy) + c2y * (Vy * Vy)) + c3y * (Uy * Vy) * Xy
    ga, gb = 2.0 * f00 + f10, 2.0 * f01 + f11
    gc, gd = f00 + 2.0 * f10, f01 + 2.0 * f11
    load = cm * (c00 * (2.0 * ga + gb) + c01 * (ga + 2.0 * gb)
                 + c10 * (2.0 * gc + gd) + c11 * (gc + 2.0 * gd))
    return ex + ey - load


def energy_plain(u, nu, f, basis: fem.BasisTables) -> torch.Tensor:
    """Plain torch Ritz energy on any device: the kernel's reference.
    Narrower types than float32 are computed in float32 and cast back."""
    return element_energy(u.float(), nu.float(), f.float(),
                          energy_consts(basis.basis)).mean().to(u.dtype)


def energy(u, nu, f, basis: fem.BasisTables) -> torch.Tensor:
    """The Ritz energy: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; any other device raises. Not differentiable (see
    :func:`poisson_energy_fused`)."""
    global launches
    check_fields("poisson_energy_fused", u, dtypes=FIELD_TYPES, nu=nu, f=f)
    if u.device.type == "cpu":
        return energy_plain(u, nu, f, basis)
    require_cuda("poisson_energy_fused", u)
    out = energy_at_strip(u, nu, f, basis,
                          strip_rows(*u.shape, sm_count(u.device)))
    launches += 1
    return out


def energy_at_strip(u, nu, f, basis: fem.BasisTables, ty: int):
    """One launch of the CUDA kernel at tile height `ty` on checked CUDA
    tensors (not counted in ``launches``): the wrapper's launch, and the
    card checks' of every strip."""
    if u[0].numel() > 2**31 - 64:
        raise ValueError("poisson_energy_fused: a sample's nodes must fit "
                         "in 31 bits (the kernel's offsets)")
    lib = load_library()
    B, ny, nx = u.shape
    partials = torch.empty(lib.poisson_energy_partials(B, ny, nx, ty),
                           dtype=torch.float32, device=u.device)
    status = lib.poisson_energy(
        u.data_ptr(), nu.data_ptr(), f.data_ptr(), partials.data_ptr(),
        B, ny, nx, ty, int(u.dtype == torch.bfloat16),
        *energy_consts(basis.basis),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "poisson_energy_fused")
    return (partials.sum() / (B * (ny - 1) * (nx - 1))).to(u.dtype)


class _Energy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, nu, f, basis):
        ctx.basis = basis
        ctx.save_for_backward(u, nu, f)
        return energy(u, nu, f, basis)

    @staticmethod
    def backward(ctx, g):
        u, nu, f = ctx.saved_tensors
        basis = ctx.basis
        B, ny, nx = u.shape
        shape = (ny, nx)
        # projections in float32 (a no-op for float32 fields), each
        # cotangent cast to its field's type
        scale = g.float() / (B * (ny - 1) * (nx - 1))
        du = dnu = df = None
        if ctx.needs_input_grad[0]:
            # dE/du = K(nu) u - Nf: the stiffness kernel plus one projection
            f_gp = fem.gp_eval(f.float(), basis, ("N",))["N"]
            Nf = fem.galerkin_project(f_gp, basis, "N", shape)
            du = (scale * (stiffness_action(u, nu, basis).float() - Nf)
                  ).to(u.dtype)
        if ctx.needs_input_grad[1]:
            gu = fem.gp_eval(u.float(), basis, ("dx", "dy"))
            dnu = (scale * fem.galerkin_project(
                0.5 * (gu["dx"] ** 2 + gu["dy"] ** 2), basis, "N", shape)
                ).to(nu.dtype)
        if ctx.needs_input_grad[2]:
            u_gp = fem.gp_eval(u.float(), basis, ("N",))["N"]
            df = (-scale * fem.galerkin_project(u_gp, basis, "N", shape)
                  ).to(f.dtype)
        return du, dnu, df, None


def poisson_energy_fused(u, nu, f, basis: fem.BasisTables) -> torch.Tensor:
    """Differentiable Ritz energy ``mean_{b,elem} sum_gp JxW (0.5 nu
    |grad u|^2 - u f)`` of nodal ``[B, ny, nx]`` fields."""
    return _Energy.apply(u, nu, f, basis)
