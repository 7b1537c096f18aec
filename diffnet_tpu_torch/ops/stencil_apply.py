"""K4: the assembled-stencil apply, 2D (9-point) and 3D (27-point).

Replaces the TPU kernels ``diffnet_tpu/ops/stencil_apply.py``
(``_apply2d_fwd``, body ``_apply_strip_2d``; ``_apply3d_fwd`` /
``_apply3d_fwd_folded``, bodies ``_apply_slab_3d`` / ``_kernel3d_dmaf``):

    out[b, p] = sum_m C[m, b, p] * u[b, p + k_m]

with the offsets ``k_m`` in ``train.stencil._offsets`` order (``m = (dj +
1) * 3 + (di + 1)`` in 2D, ``((dk + 1) * 3 + (dj + 1)) * 3 + (di + 1)`` in
3D) and a zero-pad boundary. C is ``[3**nsd, B or 1, *spatial]`` and u
``[B, *spatial]``, both float32. It is the iteration matvec of every
assembled linear solve (``train.stencil.stencil_matvec(kernel="cuda")``,
the multigrid levels of
``train.linear.multigrid_preconditioner(stencil_kernel="cuda")``): the
operator's coefficients are extracted once, then applied many times.

What bounds it on the card: bytes, 44 B a node in 2D and 116 B in 3D (the
C planes and u in, out out). The kernels (``csrc/stencil2d.cu``,
``csrc/stencil3d.cu``) give each output node a thread, read the C planes
coalesced and the u neighbourhood through L1, and read a batch-1 C with a
batch stride of 0 instead of materialising the broadcast, as the JAX
``stencil_matvec`` does. On an H100 (700 W) the 2D kernel takes 0.125 ms at
512^2 x 32 (88% of peak bandwidth) against 0.699 ms for the plain version,
the 3D one 0.095 ms at 1 x 128^3 (77%) against 0.528 ms (PERF.md).

``stencil_apply`` is differentiable as the JAX op is: du is the kernel
applied to the transposed planes (``stencil_transpose_planes``), dC is
``g * shifted(u)`` in plain torch, summed over the batch for a batch-1 C.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check, load_library
from .poisson_residual import require_cuda

__all__ = ["stencil_apply", "stencil_apply_2d", "stencil_apply_3d",
           "stencil_apply_plain", "stencil_transpose_planes", "apply_2d",
           "apply_3d"]

# Launches of the CUDA kernels, 2D and 3D (plain counts; callers reset them
# to 0).
launches = 0
launches_3d = 0


def _shift(x: torch.Tensor, k: tuple[int, ...]) -> torch.Tensor:
    """``x[..., p + k]`` on the trailing ``len(k)`` axes, zero outside."""
    pad, sl = [], [slice(None)] * (x.ndim - len(k))
    for kc, s in zip(k, x.shape[-len(k):]):
        pad.append((max(-kc, 0), max(kc, 0)))
        sl.append(slice(max(kc, 0), max(kc, 0) + s))
    flat = [p for lo_hi in reversed(pad) for p in lo_hi]   # F.pad: last first
    return F.pad(x, flat)[tuple(sl)]


def stencil_apply_plain(C: torch.Tensor, u: torch.Tensor, width: int = 3,
                        nsd: int | None = None) -> torch.Tensor:
    """Plain torch apply (any device, width and nsd): one zero pad of u and
    ``width**nsd`` shifted multiply-adds, ``C[m]`` broadcasting against the
    leading axes of u. The kernel's reference. nsd defaults to the one
    ``C.shape[0] == width**nsd`` gives."""
    if nsd is None:
        nsd = round(math.log(C.shape[0], width))
    h = (width - 1) // 2
    up = F.pad(u, (h, h) * nsd)
    lead = (slice(None),) * (u.ndim - nsd)
    out = None
    for m, idx in enumerate(np.ndindex(*((width,) * nsd))):
        sl = lead + tuple(slice(int(i), int(i) + s)
                          for i, s in zip(idx, u.shape[-nsd:]))
        term = C[m] * up[sl]
        out = term if out is None else out + term
    return out


def stencil_transpose_planes(C: torch.Tensor, nsd: int) -> torch.Tensor:
    """Coefficient planes of the transposed operator: with
    ``(A u)[p] = sum_k C_k[p] u[p+k]``, ``(A^T g)[q] = sum_k C'_k[q] g[q+k]``
    with ``C'_k[q] = C_{-k}[q+k]`` (zero outside the domain). Symmetric
    operators give ``C' == C``."""
    M = C.shape[0]
    planes = []
    for m in range(M):
        k = tuple(int(c) - 1 for c in np.unravel_index(m, (3,) * nsd))
        mneg = int(np.ravel_multi_index(tuple(1 - kc for kc in k),
                                        (3,) * nsd))
        planes.append(_shift(C[mneg], k))
    return torch.stack(planes)


def _shifted_u(u: torch.Tensor, nsd: int) -> torch.Tensor:
    """All width-3 shifted copies of u (zero-filled), offset-major: the dC
    cotangent factors."""
    return torch.stack([_shift(u, tuple(int(c) - 1 for c in idx))
                        for idx in np.ndindex(*((3,) * nsd))])


def _check(C: torch.Tensor, u: torch.Tensor, nsd: int) -> None:
    op = "stencil_apply"
    if u.dim() != nsd + 1 or min(u.shape) < 1:
        dims = "nz, ny, nx" if nsd == 3 else "ny, nx"
        raise ValueError(f"{op}: u must be [B, {dims}], got "
                         f"{tuple(u.shape)}")
    B = u.shape[0]
    if C.dim() != nsd + 2 or C.shape[0] != 3**nsd \
            or C.shape[1] not in (1, B) or C.shape[2:] != u.shape[1:]:
        raise ValueError(f"{op}: C must be [{3**nsd}, {B} or 1, "
                         f"{', '.join(map(str, u.shape[1:]))}], got "
                         f"{tuple(C.shape)}")
    for name, t in (("C", C), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{op}: {name} is on {t.device}, u on "
                             f"{u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def _apply(C: torch.Tensor, u: torch.Tensor, nsd: int) -> torch.Tensor:
    """The apply: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises. Not differentiable (see
    :func:`stencil_apply`)."""
    global launches, launches_3d
    _check(C, u, nsd)
    if u.device.type == "cpu":
        return stencil_apply_plain(C, u, nsd=nsd)
    require_cuda("stencil_apply", u)
    B, spatial, Bc = u.shape[0], tuple(u.shape[1:]), C.shape[1]
    field = math.prod(spatial)
    if nsd == 3 and B * spatial[0] > 65535:
        raise ValueError(f"stencil_apply: batch x nz {B} x {spatial[0]} "
                         "exceeds the grid limit 65535")
    lib = load_library()
    out = torch.empty_like(u)
    entry = lib.stencil_apply_2d if nsd == 2 else lib.stencil_apply_3d
    status = entry(C.data_ptr(), 0 if Bc == 1 else field, u.data_ptr(),
                   out.data_ptr(), B, Bc, *spatial,
                   torch.cuda.current_stream(u.device).cuda_stream)
    check(status, f"stencil_apply_{nsd}d")
    if nsd == 2:
        launches += 1
    else:
        launches_3d += 1
    return out


def apply_2d(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The 9-point apply (see :func:`_apply`)."""
    return _apply(C, u, 2)


def apply_3d(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The 27-point apply (see :func:`_apply`)."""
    return _apply(C, u, 3)


class _StencilApply(torch.autograd.Function):

    @staticmethod
    def forward(ctx, C, u, nsd):
        ctx.nsd = nsd
        ctx.save_for_backward(C, u)
        return _apply(C, u, nsd)

    @staticmethod
    def backward(ctx, g):
        C, u = ctx.saved_tensors
        nsd = ctx.nsd
        g = g.contiguous()
        dC = du = None
        if ctx.needs_input_grad[0]:
            dC = g[None] * _shifted_u(u, nsd)
            if C.shape[1] == 1:
                dC = dC.sum(1, keepdim=True)
        if ctx.needs_input_grad[1]:
            du = _apply(stencil_transpose_planes(C, nsd).contiguous(), g,
                        nsd)
        return dC, du, None


def stencil_apply(C: torch.Tensor, u: torch.Tensor,
                  nsd: int = 2) -> torch.Tensor:
    """Differentiable width-3 stencil apply ``out[p] = sum_m C[m][p]
    u[p + k_m]`` on 2 or 3 spatial axes (see the module docstring)."""
    if nsd not in (2, 3):
        raise ValueError(f"nsd must be 2 or 3, got {nsd}")
    if torch.is_grad_enabled() and (C.requires_grad or u.requires_grad):
        return _StencilApply.apply(C, u, nsd)
    return _apply(C, u, nsd)


def stencil_apply_2d(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return stencil_apply(C, u, 2)


def stencil_apply_3d(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return stencil_apply(C, u, 3)
