"""K1: the assembled deg-1 2D Poisson stiffness action K(nu) u.

Replaces the TPU kernel ``diffnet_tpu/ops/poisson_residual.py``
(``_stiffness_fwd_impl`` / ``_stiffness_fwd_bs``, body ``_strip_lr``):

    Ku[b, j, i] = sum_{elements e adjacent to node (j, i)} sum_gp
                  JxW_gp * nu(e, gp) * grad N_(j,i) . grad u (e, gp)

for bilinear elements with 2x2 Gauss points, on square or rectangular
``[B, ny, nx]`` fields.

u and nu are both float32 or both bfloat16, as the JAX kernel's fields may
be; the output has their type. The bfloat16 path loads the narrow type,
computes in float32 and rounds once on the store (the plain version
upcasts, computes and casts back).

What bounds it on the card: bytes. It moves u and nu in and Ku out, 12 B a
node in float32 (about 101 MB at 512^2, batch 32) and 6 B in bfloat16,
against ~49 operations an element. The first kernel, a thread a node
summing its four elements in gather form, computed each element body four
times and ran at 0.112 ms at 512^2 x 32 on an H100 (700 W), 27% of its byte
bound (PERF.md). The kernel (``csrc/poisson2d.cu::stiffness_kernel``) now
gives each warp a tile of 64 node columns and ``strip_rows`` node rows: it
stages u and nu on the tile and a one-node halo in shared memory with
asynchronous copies, computes each element of the tile once (a lane walks
down two columns of elements, its neighbour's corner sums come by
shuffle), and writes each row of the tile with one coalesced store, a node
pair a lane. It sums in the first kernel's order, so float32 results are
bit-for-bit the same. No atomics, the same result on every run; the TPU
tiling, padding and DMA pipelining are not carried over.

``poisson_stiffness_action`` is differentiable: the action is self-adjoint
in u, so du = K(nu) g runs the same kernel, and d/dnu is one Galerkin
projection of grad u . grad g.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import fem
from ..core.quadrature import FEMBasis
from ._build import check, load_library, sm_count

__all__ = ["poisson_stiffness_action", "poisson_residual_fused",
           "stiffness_action", "stiffness_action_plain"]

# Launches of the CUDA kernel (a plain count; callers reset it to 0).
launches = 0

# The kernel's tiling (csrc/poisson2d.cu): a block is one warp that owns
# COLS node columns and a strip of node rows, one of STRIPS long (the
# kernel takes 1 to 31). On an H100, 5 rows beat longer and shorter strips
# at 512^2 x 32 and 1 x 513^2, and shorter strips win on grids that give
# the card fewer than two warps an SM: 2 rows at 257^2, one at 64^2
# (PERF.md).
COLS = 64
STRIPS = (5, 2, 1)
MIN_WARPS_PER_SM = 2
# the field types K1 and K3 take (the others take float32 only)
FIELD_TYPES = (torch.float32, torch.bfloat16)


def longest_strip(tiles_across: int, rows: int, strips: tuple[int, ...],
                  min_warps_per_sm: int, sms: int) -> int:
    """The longest of `strips` (longest first) whose launch of one warp a
    tile, `tiles_across` tiles times ceil(rows / strip), still gives each
    of `sms` SMs `min_warps_per_sm` warps; else the shortest. K1, K2 and
    K3 pick their tile heights so."""
    for ty in strips:
        if tiles_across * -(-rows // ty) >= min_warps_per_sm * sms:
            return ty
    return strips[-1]


def strip_rows(B: int, ny: int, nx: int, sms: int) -> int:
    """Node rows of a K1 tile for a ``[B, ny, nx]`` launch on `sms` SMs:
    the longest strip whose launch still gives each SM ``MIN_WARPS_PER_SM``
    warps, else the shortest."""
    return longest_strip(B * -(-nx // COLS), ny, STRIPS, MIN_WARPS_PER_SM,
                         sms)


def q1_geometry(basis: FEMBasis) -> tuple[float, float, float, float]:
    """(d2, W, hx, hy) of a deg-1 2D 2x2-Gauss basis: d2 = (p - q)^2 with
    p, q = (1 -+ xi) / 2 the 1D shape values at the first Gauss point xi,
    and W the (equal) JxW of the four Gauss points."""
    if not (basis.deg == 1 and basis.nsd == 2 and basis.ngp_1d == 2):
        raise ValueError("the fused Poisson kernels support deg-1 2D with "
                         "2x2 Gauss points only")
    xi = float(basis.gp_1d[0])
    hx, hy = (float(v) for v in basis.h)
    return xi * xi, float(basis.jxw[0]), hx, hy


def stiffness_consts(basis: FEMBasis) -> tuple[float, float, float, float]:
    """Folded constants (k1x, k2x, k1y, k2y) of the sum-factorised element
    body: k1 = W/(4 h^2), k2 = W d2/(4 h^2) per axis."""
    d2, W, hx, hy = q1_geometry(basis)
    wx2, wy2 = W / hx**2, W / hy**2
    return wx2 / 4.0, wx2 * d2 / 4.0, wy2 / 4.0, wy2 * d2 / 4.0


def element_contributions(u: torch.Tensor, nu: torch.Tensor,
                          k: tuple[float, float, float, float]):
    """Per-element contributions (a0, a1, a2, a3) to corners 00, 01, 10, 11
    (first index y), each ``[B, ny-1, nx-1]``: the plain torch form of the
    kernel's ``element_body``."""
    k1x, k2x, k1y, k2y = k
    c00, c01 = u[..., :-1, :-1], u[..., :-1, 1:]
    c10, c11 = u[..., 1:, :-1], u[..., 1:, 1:]
    n00, n01 = nu[..., :-1, :-1], nu[..., :-1, 1:]
    n10, n11 = nu[..., 1:, :-1], nu[..., 1:, 1:]
    dxl, dxh = c01 - c00, c11 - c10
    dyl, dyh = c10 - c00, c11 - c01
    sxr0, sxr1 = n00 + n01, n10 + n11
    syc0, syc1 = n00 + n10, n01 + n11
    nsum = sxr0 + sxr1

    Ux, Vx, Xx = dxl + dxh, dxl - dxh, sxr0 - sxr1
    Mx = Vx * Xx
    Qx = Ux * Xx + Vx * nsum
    Rx = k1x * (Ux * nsum)
    px0 = Rx + k2x * (Mx + Qx)
    px1 = Rx + k2x * (Mx - Qx)
    Uy, Vy, Xy = dyl + dyh, dyl - dyh, syc0 - syc1
    My = Vy * Xy
    Qy = Uy * Xy + Vy * nsum
    Ry = k1y * (Uy * nsum)
    py0 = Ry + k2y * (My + Qy)
    py1 = Ry + k2y * (My - Qy)
    return -px0 - py0, px0 - py1, py0 - px1, px1 + py1


def assemble_corners(a0, a1, a2, a3) -> torch.Tensor:
    """Q1 node assembly of per-element corner contributions:
    ``[..., nely, nelx]`` x 4 -> ``[..., nely+1, nelx+1]``."""
    return (F.pad(a0, (0, 1, 0, 1)) + F.pad(a1, (1, 0, 0, 1))
            + F.pad(a2, (0, 1, 1, 0)) + F.pad(a3, (1, 0, 1, 0)))


def stiffness_action_plain(u: torch.Tensor, nu: torch.Tensor,
                           basis: fem.BasisTables) -> torch.Tensor:
    """Plain torch K(nu) u (any device): the kernel's reference. Narrower
    types than float32 are computed in float32 and cast back."""
    if u.dtype == torch.bfloat16:
        return stiffness_action_plain(u.float(), nu.float(),
                                      basis).to(u.dtype)
    return assemble_corners(*element_contributions(
        u, nu, stiffness_consts(basis.basis)))


def check_fields(op: str, u: torch.Tensor, nsd: int = 2,
                 dtypes: tuple[torch.dtype, ...] = (torch.float32,),
                 **others: torch.Tensor) -> None:
    """What the kernels take: contiguous ``[B, ny, nx]`` (nsd 2) or
    ``[B, nz, ny, nx]`` (nsd 3) fields of at least 2 nodes an axis, all on
    one device, of one shape and of one type among `dtypes`."""
    if u.dim() != nsd + 1 or u.shape[0] < 1 or min(u.shape[1:]) < 2:
        dims = ("nz, ny, nx" if nsd == 3 else "ny, nx")
        raise ValueError(f"{op}: u must be [B, {dims}] with {dims} >= 2, "
                         f"got {tuple(u.shape)}")
    names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
    for name, t in {"u": u, **others}.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{op}: {name} must be {names}, got {t.dtype}")
        if t.dtype != u.dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}, u {u.dtype} (one "
                            "type for all fields)")
        if t.device != u.device:
            raise ValueError(f"{op}: {name} is on {t.device}, u on "
                             f"{u.device}")
        if t.shape != u.shape:
            raise ValueError(f"{op}: {name}.shape {tuple(t.shape)} != "
                             f"u.shape {tuple(u.shape)} (no broadcasting)")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def require_cuda(op: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{op}: tensors on {t.device} are not supported "
                         "(the plain version runs on the CPU, the kernel on "
                         "CUDA)")
    if t.shape[0] > 65535:
        raise ValueError(f"{op}: batch {t.shape[0]} exceeds the grid limit "
                         "65535")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it when its data does not start on a 16-B boundary
    (a view at an offset): the kernels' 16-B copies need aligned bases."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stiffness_action(u: torch.Tensor, nu: torch.Tensor,
                     basis: fem.BasisTables) -> torch.Tensor:
    """K(nu) u for float32 or bfloat16 fields, in their type: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors; any other
    device raises. Not differentiable (see
    :func:`poisson_stiffness_action`)."""
    global launches
    check_fields("poisson_stiffness_action", u, dtypes=FIELD_TYPES, nu=nu)
    if u.device.type == "cpu":
        return stiffness_action_plain(u, nu, basis)
    require_cuda("poisson_stiffness_action", u)
    if u[0].numel() * u.element_size() > 2**31 - 64:
        raise ValueError("poisson_stiffness_action: a sample's bytes must "
                         "fit in 31 bits (the kernel's offsets)")
    lib = load_library()
    u, nu = aligned16(u), aligned16(nu)
    out = torch.empty_like(u)
    B, ny, nx = u.shape
    status = lib.poisson_stiffness_action(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), B, ny, nx,
        strip_rows(B, ny, nx, sm_count(u.device)),
        int(u.dtype == torch.bfloat16), *stiffness_consts(basis.basis),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "poisson_stiffness_action")
    launches += 1
    return out


def nu_projection(u: torch.Tensor, w: torch.Tensor,
                  basis: fem.BasisTables) -> torch.Tensor:
    """Assembled ``∫ N_c grad u . grad w``: the nu-cotangent of
    ``<w, K(nu) u>`` (2D or 3D, as the basis); bfloat16 fields are
    projected in float32 and the result cast back."""
    if u.dtype == torch.bfloat16:
        return nu_projection(u.float(), w.float(), basis).to(u.dtype)
    grads = ("dx", "dy", "dz")[:basis.nsd]
    gu = fem.gp_eval(u, basis, grads)
    gw = fem.gp_eval(w, basis, grads)
    return fem.galerkin_project(sum(gu[q] * gw[q] for q in grads), basis,
                                "N", u.shape[-basis.nsd:])


class _StiffnessAction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, nu, basis):
        ctx.basis = basis
        ctx.save_for_backward(u, nu)
        return stiffness_action(u, nu, basis)

    @staticmethod
    def backward(ctx, g):
        u, nu = ctx.saved_tensors
        g = g.contiguous()
        du = dnu = None
        if ctx.needs_input_grad[0]:
            # self-adjoint in u: the same kernel
            du = stiffness_action(g, nu, ctx.basis)
        if ctx.needs_input_grad[1]:
            dnu = nu_projection(u, g, ctx.basis)
        return du, dnu, None


def poisson_stiffness_action(u: torch.Tensor, nu: torch.Tensor,
                             basis: fem.BasisTables) -> torch.Tensor:
    """Differentiable assembled ``∫ nu grad N_i . grad u``:
    ``[B, ny, nx] -> [B, ny, nx]`` (rectangular fields allowed)."""
    return _StiffnessAction.apply(u, nu, basis)


def poisson_residual_fused(u: torch.Tensor, nu: torch.Tensor,
                           Nf: torch.Tensor, bc_mask: torch.Tensor,
                           basis: fem.BasisTables) -> torch.Tensor:
    """Assembled, Dirichlet-masked residual
    ``where(bc_mask > 0.5, 0, K(nu) u - Nf)``; `Nf` is the preassembled
    load vector ``∫ N_i f``, `bc_mask` ``[ny, nx]`` or ``[B, ny, nx]``."""
    R = poisson_stiffness_action(u, nu, basis) - Nf
    return torch.where(bc_mask > 0.5, torch.zeros_like(R), R)
