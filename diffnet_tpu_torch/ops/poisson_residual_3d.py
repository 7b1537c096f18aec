"""K5: the assembled deg-1 3D Poisson stiffness action K(nu) u.

Replaces the TPU kernel ``diffnet_tpu/ops/poisson_residual_3d.py``
(``_stiffness3d_fwd_impl`` / ``_stiffness3d_fwd_bs`` /
``_stiffness3d_fwd_folded``, bodies ``_slab_assemble`` and
``_slab_assemble_folded``):

    Ku[b, k, j, i] = sum_{elements e adjacent to node (k, j, i)} sum_gp
                     JxW_gp * nu(e, gp) * grad N_(k,j,i) . grad u (e, gp)

for trilinear elements with 2x2x2 Gauss points on ``[B, nz, n, n]``
fields (nz may differ from n; ny == nx, as the JAX op requires).

The element body is the JAX package's sum-factorised algebra: for deg 1,
dN/dxi is constant along its own axis, so each axis' part of the action
needs only the four u differences D and four nu sums S along that axis;
per Gauss pair of the two other axes the interpolated derivative and nu
multiply, and the products project back onto the two test values of each
of those axes. The eight corner contributions are the signed sums of the
three axis parts.

What bounds it on the card: operations. It moves u and nu in and Ku out,
12 B a node (12.6 MB at 4 x 64^3, 3.8 us at 3.35 TB/s), against about 280
fp32 operations an element in the JAX package's sum-factorised body, and 7
a node to assemble (0.29 GFLOP at 4 x 64^3, 4.3 us at 67 TFLOP/s; JAX's
cost estimate says 800 an element). The kernel (``csrc/poisson3d.cu``)
walks: a block of WARPS warps stacked in y over 32 element columns walks a
strip of node planes in z (``strip_planes``); each lane computes its
element once a step from node planes it loads into registers, carries the
upper plane's corner sums to the next step, and takes its x-neighbour's by
shuffle and its y-neighbour's from the warp before through shared memory.
Its body is the same algebra in the Gauss pair's sum/difference basis
(~140 fp32 instructions an element). No atomics, and the same result on
every run. The TPU tiling (z slabs, folded z, VMEM budgets, DMA halos) is
not carried over. PERF.md has its times on an H100, against the plain
version's and the earlier tiled kernel's.

``poisson_stiffness_action_3d`` is differentiable: the action is
self-adjoint in u, so du = K(nu) g runs the same kernel, and d/dnu is one
Galerkin projection of grad u . grad g.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import fem
from ..core.quadrature import FEMBasis
from ._build import check, load_library, sm_count
from .poisson_residual import check_fields, nu_projection, require_cuda

__all__ = ["poisson_stiffness_action_3d", "poisson_residual_fused_3d",
           "stiffness_action_3d", "stiffness_action_3d_plain"]

# Launches of the CUDA kernel (a plain count; callers reset it to 0).
launches = 0

# The kernel's tiling (csrc/poisson3d.cu): a block is WARPS warps stacked in
# y over 32 element columns; warp 0 computes the element row above the
# block's WARPS - 1 node rows. It walks a strip of node planes, at most
# STRIPS[0]: the longest of STRIPS whose launch still gives each SM
# MIN_WARPS_PER_SM warps, split evenly over the grid's planes.
COLS = 32
WARPS = 8
STRIPS = (31, 16, 8, 4, 2, 1)
MIN_WARPS_PER_SM = 32


def strip_planes(B: int, nz: int, ny: int, nx: int, sms: int) -> int:
    """Node planes a block walks for a ``[B, nz, ny, nx]`` launch on `sms`
    SMs: the longest of STRIPS whose launch still gives each SM
    ``MIN_WARPS_PER_SM`` warps (else the shortest), evened out so that the
    grid's planes split into strips of equal length."""
    blocks = B * -(-(nx - 1) // COLS) * -(-ny // (WARPS - 1))
    tz = STRIPS[-1]
    for s in STRIPS:
        if blocks * -(-nz // s) * WARPS >= MIN_WARPS_PER_SM * sms:
            tz = s
            break
    return -(-nz // -(-nz // tz))


def stiffness_consts_3d(basis: FEMBasis) -> tuple[float, ...]:
    """``(cN00, cN01, cN10, cN11, wx2, wy2, wz2)``: the 1D shape values
    ``cN[g][node] = (1 -+ xi_g) / 2`` at the two Gauss points and the folded
    scales ``W / h_axis^2`` (W the equal JxW of the eight Gauss points)."""
    if not (basis.deg == 1 and basis.nsd == 3 and basis.ngp_1d == 2):
        raise ValueError("the fused 3D Poisson kernel supports deg-1 3D with "
                         "2x2x2 Gauss points only")
    xi = np.asarray(basis.gp_1d, np.float64)
    jxw = np.asarray(basis.jxw, np.float64)
    W = float(jxw[0])
    if not np.allclose(jxw, W):
        raise ValueError("2x2x2 Gauss points must have equal JxW")
    hx, hy, hz = (float(v) for v in basis.h)
    cN = [((1.0 - x) / 2.0, (1.0 + x) / 2.0) for x in xi]
    return (cN[0][0], cN[0][1], cN[1][0], cN[1][1],
            W / hx**2, W / hy**2, W / hz**2)


def _contract(M, X):
    """``sum_j M[i, j] X[j]`` of a ``[4, 4]`` matrix and four tensors:
    ``[4, ...]``, in four broadcast products (no matmul: BLAS threads
    crawl in a test worker beside others)."""
    Mb = M.view(4, 4, *[1] * X[0].dim())
    return Mb[:, 0] * X[0] + Mb[:, 1] * X[1] + Mb[:, 2] * X[2] + Mb[:, 3] * X[3]


def _part(K, D, S, scale):
    """One axis' part: the differences `D` and sums `S` (four each, over
    the two other axes' corner offsets (a, b)) -> ``p[(ab, bb), ...]``:
    per Gauss pair (ga, gb) of those axes the interpolated derivative
    times the interpolated nu, projected onto their test values (K[(ga,
    gb), (a, b)] the products of the 1D shape values)."""
    t = _contract(K, D) * _contract(K, S)
    return scale * _contract(K.T.contiguous(), t)


def element_contributions_3d(u: torch.Tensor, nu: torch.Tensor,
                             k: tuple[float, ...]) -> torch.Tensor:
    """Per-element contributions to the eight corners, ``[kb, jb, ib, B,
    nz-1, ny-1, nx-1]`` (the corner's z, y, x offsets): the plain torch
    form of the kernel's element body, each axis' part a few batched
    products over the corner views (dozens of operations, not one for
    each product)."""
    c00, c01, c10, c11, wx2, wy2, wz2 = k
    K = torch.kron(*[u.new_tensor([[c00, c01], [c10, c11]])] * 2)

    def view(x, kk, j, i):
        return x[..., kk:x.shape[-3] - 1 + kk, j:x.shape[-2] - 1 + j,
                 i:x.shape[-1] - 1 + i]

    uc = [[[view(u, kk, j, i) for i in (0, 1)] for j in (0, 1)]
          for kk in (0, 1)]
    nc = [[[view(nu, kk, j, i) for i in (0, 1)] for j in (0, 1)]
          for kk in (0, 1)]
    ab = [(0, 0), (0, 1), (1, 0), (1, 1)]
    px = _part(K, [uc[a][b][1] - uc[a][b][0] for a, b in ab],
               [nc[a][b][0] + nc[a][b][1] for a, b in ab], wx2)  # (kb, jb)
    py = _part(K, [uc[a][1][b] - uc[a][0][b] for a, b in ab],
               [nc[a][0][b] + nc[a][1][b] for a, b in ab], wy2)  # (kb, ib)
    pz = _part(K, [uc[1][a][b] - uc[0][a][b] for a, b in ab],
               [nc[0][a][b] + nc[1][a][b] for a, b in ab], wz2)  # (jb, ib)
    rest = px.shape[1:]
    px, py, pz = (p.view(2, 2, *rest) for p in (px, py, pz))
    sgn = u.new_tensor([-1.0, 1.0]).view(2, *[1] * len(rest))
    # corner (kb, jb, ib): sgn[ib] px[kb, jb] + sgn[jb] py[kb, ib]
    # + sgn[kb] pz[jb, ib]
    return px[:, :, None] * sgn + py[:, None] * sgn[:, None] + pz * sgn[
        :, None, None]


def assemble_corners_3d(a: torch.Tensor) -> torch.Tensor:
    """Trilinear node assembly of per-element corner contributions:
    ``[2, 2, 2, ..., nelz, nely, nelx]`` (the corner's z, y, x offsets) ->
    ``[..., nelz+1, nely+1, nelx+1]``."""
    out = None
    for kb in (0, 1):
        for jb in (0, 1):
            for ib in (0, 1):
                piece = F.pad(a[kb, jb, ib],
                              (ib, 1 - ib, jb, 1 - jb, kb, 1 - kb))
                out = piece if out is None else out + piece
    return out


def stiffness_action_3d_plain(u: torch.Tensor, nu: torch.Tensor,
                              basis: fem.BasisTables) -> torch.Tensor:
    """Plain torch K(nu) u (any device): the kernel's reference."""
    return assemble_corners_3d(element_contributions_3d(
        u, nu, stiffness_consts_3d(basis.basis)))


def stiffness_action_3d(u: torch.Tensor, nu: torch.Tensor,
                        basis: fem.BasisTables) -> torch.Tensor:
    """K(nu) u: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; any other device raises. Not differentiable (see
    :func:`poisson_stiffness_action_3d`)."""
    global launches
    op = "poisson_stiffness_action_3d"
    check_fields(op, u, 3, nu=nu)
    if u.shape[2] != u.shape[3]:
        raise ValueError(f"{op}: the 3D kernel needs ny == nx (as the JAX "
                         f"op does), got {tuple(u.shape[2:])}")
    if u.device.type == "cpu":
        return stiffness_action_3d_plain(u, nu, basis)
    require_cuda(op, u)
    B, nz, ny, nx = u.shape
    tz = strip_planes(B, nz, ny, nx, sm_count(u.device))
    if B * -(-nz // tz) > 65535 or -(-ny // (WARPS - 1)) > 65535:
        raise ValueError(f"{op}: batch x strips {B} x {-(-nz // tz)} or "
                         f"{-(-ny // (WARPS - 1))} row blocks exceed the grid "
                         "limit 65535")
    lib = load_library()
    out = torch.empty_like(u)
    status = lib.poisson_stiffness_action_3d(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), B, nz, ny, nx, tz,
        *stiffness_consts_3d(basis.basis),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, op)
    launches += 1
    return out


class _StiffnessAction3D(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, nu, basis):
        ctx.basis = basis
        ctx.save_for_backward(u, nu)
        return stiffness_action_3d(u, nu, basis)

    @staticmethod
    def backward(ctx, g):
        u, nu = ctx.saved_tensors
        g = g.contiguous()
        du = dnu = None
        if ctx.needs_input_grad[0]:
            # self-adjoint in u: the same kernel
            du = stiffness_action_3d(g, nu, ctx.basis)
        if ctx.needs_input_grad[1]:
            dnu = nu_projection(u, g, ctx.basis)
        return du, dnu, None


def poisson_stiffness_action_3d(u: torch.Tensor, nu: torch.Tensor,
                                basis: fem.BasisTables) -> torch.Tensor:
    """Differentiable assembled ``∫ nu grad N_i . grad u``:
    ``[B, nz, n, n] -> [B, nz, n, n]``."""
    return _StiffnessAction3D.apply(u, nu, basis)


def poisson_residual_fused_3d(u: torch.Tensor, nu: torch.Tensor,
                              Nf: torch.Tensor, bc_mask: torch.Tensor,
                              basis: fem.BasisTables) -> torch.Tensor:
    """Assembled, Dirichlet-masked 3D residual
    ``where(bc_mask > 0.5, 0, K(nu) u - Nf)``; `Nf` is the preassembled
    load vector ``∫ N_i f``, `bc_mask` ``[nz, n, n]`` or ``[B, nz, n, n]``."""
    if nu.shape != u.shape:
        raise ValueError(f"nu.shape {tuple(nu.shape)} != u.shape "
                         f"{tuple(u.shape)} (the fused kernel does not "
                         "broadcast)")
    R = poisson_stiffness_action_3d(u, nu, basis) - Nf
    return torch.where(bc_mask > 0.5, torch.zeros_like(R), R)
