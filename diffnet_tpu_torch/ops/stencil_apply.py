"""K4: the assembled-stencil apply, 2D (9-point).

Replaces the TPU kernel ``diffnet_tpu/ops/stencil_apply.py``
(``_apply2d_fwd``, body ``_apply_strip_2d``):

    out[b, j, i] = sum_m C[m, b, j, i] * u[b, j + dj, i + di]

with ``m = (dj + 1) * 3 + (di + 1)`` in ``train.stencil._offsets`` order
and a zero-pad boundary. C is ``[9, B or 1, ny, nx]`` and u ``[B, ny, nx]``,
both float32. It is the iteration matvec of every assembled linear solve
(``train.stencil.stencil_matvec(kernel="cuda")``, the multigrid levels of
``train.linear.multigrid_preconditioner(stencil_kernel="cuda")``): the
operator's coefficients are extracted once, then applied many times.

What bounds it on the card: bytes, 44 B a node (9 C planes and u in, out
out). The kernel (``csrc/stencil2d.cu``) gives each output node a thread,
reads the C planes coalesced and the 3x3 u neighbourhood through L1, and
reads a batch-1 C with a batch stride of 0 instead of materialising the
broadcast, as the JAX ``stencil_matvec`` does. At 512^2 x 32 it takes
0.131 ms on an H100 (700 W), 2.83 TB/s or 84% of peak bandwidth, against
0.708 ms for the plain version (PERF.md).

``stencil_apply`` is differentiable as the JAX op is: du is the kernel
applied to the transposed planes (``stencil_transpose_planes``), dC is
``g * shifted(u)`` in plain torch. The 27-point 3D apply is not ported yet
(ROADMAP, the 3D slice).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check, load_library
from .poisson_residual import require_cuda

__all__ = ["stencil_apply", "stencil_apply_2d", "stencil_apply_plain",
           "stencil_transpose_planes", "apply_2d"]

# Launches of the CUDA kernel (a plain count; callers reset it to 0).
launches = 0


def _require_2d(nsd: int) -> None:
    if nsd == 3:
        raise NotImplementedError(
            "the 27-point 3D stencil apply is not ported yet (ROADMAP, the "
            "3D slice: K4-3D with K5); drop kernel= for the plain path")
    if nsd != 2:
        raise ValueError(f"nsd must be 2 or 3, got {nsd}")


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


def _check(C: torch.Tensor, u: torch.Tensor) -> None:
    op = "stencil_apply"
    if u.dim() != 3 or min(u.shape) < 1:
        raise ValueError(f"{op}: u must be [B, ny, nx], got "
                         f"{tuple(u.shape)}")
    B = u.shape[0]
    if C.dim() != 4 or C.shape[0] != 9 or C.shape[1] not in (1, B) \
            or C.shape[2:] != u.shape[1:]:
        raise ValueError(f"{op}: C must be [9, {B} or 1, "
                         f"{u.shape[1]}, {u.shape[2]}], got "
                         f"{tuple(C.shape)}")
    for name, t in (("C", C), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{op}: {name} is on {t.device}, u on "
                             f"{u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def apply_2d(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The apply: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises. Not differentiable (see
    :func:`stencil_apply`)."""
    global launches
    _check(C, u)
    if u.device.type == "cpu":
        return stencil_apply_plain(C, u, nsd=2)
    require_cuda("stencil_apply", u)
    B, ny, nx = u.shape
    Bc = C.shape[1]
    lib = load_library()
    out = torch.empty_like(u)
    status = lib.stencil_apply_2d(
        C.data_ptr(), 0 if Bc == 1 else ny * nx, u.data_ptr(),
        out.data_ptr(), B, Bc, ny, nx,
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "stencil_apply_2d")
    launches += 1
    return out


class _StencilApply(torch.autograd.Function):

    @staticmethod
    def forward(ctx, C, u):
        ctx.save_for_backward(C, u)
        return apply_2d(C, u)

    @staticmethod
    def backward(ctx, g):
        C, u = ctx.saved_tensors
        g = g.contiguous()
        dC = du = None
        if ctx.needs_input_grad[0]:
            dC = g[None] * _shifted_u(u, 2)
            if C.shape[1] == 1:
                dC = dC.sum(1, keepdim=True)
        if ctx.needs_input_grad[1]:
            du = apply_2d(stencil_transpose_planes(C, 2).contiguous(), g)
        return dC, du


def stencil_apply(C: torch.Tensor, u: torch.Tensor,
                  nsd: int = 2) -> torch.Tensor:
    """Differentiable width-3 stencil apply ``out[p] = sum_m C[m][p]
    u[p + k_m]`` (see the module docstring); ``nsd=3`` raises
    NotImplementedError."""
    _require_2d(nsd)
    if torch.is_grad_enabled() and (C.requires_grad or u.requires_grad):
        return _StencilApply.apply(C, u)
    return apply_2d(C, u)


def stencil_apply_2d(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return stencil_apply(C, u, 2)
