"""Assembled-stencil form of linear grid operators (port of
``diffnet_tpu/train/stencil.py``).

Every deg-1 Galerkin residual on a nodal tensor-product grid is a width-3
variable-coefficient stencil

    (A u)[p] = sum_{k in {-1,0,1}^nsd} C_k[p] * u[p + k]

(deg-d elements couple d+1 nodes per axis: width 2d+1). The coefficient
field C (``width**nsd`` planes, one per offset) is recovered exactly from
``width**nsd`` colouring probes: a probe with ones on a stride-``width``
lattice puts exactly one probe node inside each output node's stencil, so
every coefficient lands untangled in some probe's output, and taps outside
the domain extract as 0. An iterative solve then applies C (one pass of
``width**nsd`` multiply-adds, or the K4 kernel) instead of re-running the
element assembly every iteration.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.stencil_apply import stencil_apply, stencil_apply_plain
from ..utils.device import resolve_device

__all__ = ["extract_stencil", "stencil_matvec", "stencil_diag",
           "extract_verified", "assemble_stencil"]

def _offsets(width: int, nsd: int):
    h = (width - 1) // 2
    return [tuple(int(c) - h for c in idx)
            for idx in np.ndindex(*((width,) * nsd))]


def check_kernel(kernel: str | None) -> None:
    """Accept ``kernel=None`` (the plain apply) or ``"cuda"`` (K4); any
    other name, such as the JAX package's TPU variants ``"dma"`` and
    ``"blockspec"``, raises ValueError."""
    if kernel not in (None, "cuda"):
        raise ValueError(f"kernel={kernel!r}: the port has one stencil "
                         "kernel, 'cuda' (the JAX package's TPU variants "
                         "are not ported)")


@torch.no_grad()
def extract_stencil(A: Callable, shape, width: int = 3,
                    nsd: int | None = None, device="cuda") -> torch.Tensor:
    """The full stencil coefficient field of a linear operator.

    A: linear map on float32 fields of ``shape`` on `device` (the card by
        default; leading axes
        of ``shape`` are carried along, e.g. a batch of per-sample
        operators; the stencil acts on the trailing ``nsd`` axes). It is
        called once per probe, ``width**nsd`` times, with one field each.
    width: stencil width per axis (3 for deg-1 elements, 2*deg+1 for deg).

    Returns ``C`` ``[width**nsd, *shape]`` on `device`, ``C[m]`` the
    coefficient of offset ``_offsets(width, nsd)[m]``.
    """
    device = resolve_device(device, "extract_stencil")
    shape = tuple(int(s) for s in shape)
    if nsd is None:
        nsd = len(shape)
    spatial = shape[-nsd:]
    outs = []
    for idx in np.ndindex(*((width,) * nsd)):
        e = np.zeros(spatial, np.float32)
        e[tuple(slice(o, None, width) for o in idx)] = 1.0
        probe = torch.from_numpy(np.broadcast_to(e, shape).copy()).to(device)
        outs.append(A(probe).detach().cpu().numpy())
    outs = np.stack(outs)

    # C_k[p] = outs[color(p + k)][p], color(q) = ravel(q mod width) on the
    # trailing nsd axes: for each offset, positions in residue class r all
    # read probe (r + k) mod width (host-side strided copies, setup only)
    lead = (slice(None),) * (len(shape) - nsd)
    C = np.zeros((width ** nsd,) + shape, np.float32)
    for m, k in enumerate(_offsets(width, nsd)):
        for r_idx in np.ndindex(*((width,) * nsd)):
            c = 0
            for rc, kc in zip(r_idx, k):
                c = c * width + (rc + kc) % width
            sl = lead + tuple(slice(rc, None, width) for rc in r_idx)
            C[(m,) + sl] = outs[(c,) + sl]
    return torch.from_numpy(C).to(device)


def stencil_matvec(C: torch.Tensor, u: torch.Tensor, width: int = 3,
                   nsd: int | None = None,
                   kernel: str | None = None) -> torch.Tensor:
    """Apply an extracted stencil: one zero pad of ``u`` plus
    ``width**nsd`` shifted multiply-adds.

    kernel: ``"cuda"`` routes the apply through the K4 kernel
    (:mod:`diffnet_tpu_torch.ops.stencil_apply`; on CPU tensors its plain
    version). Width 3 on 2 or 3 spatial axes; leading axes are collapsed into
    the kernel's batch axis, and a C shared by the batch is read with a
    batch stride of 0."""
    if nsd is None:
        nsd = u.ndim
    if kernel is None:
        return stencil_apply_plain(C, u, width=width, nsd=nsd)
    check_kernel(kernel)
    if width != 3 or nsd not in (2, 3):
        raise ValueError(
            "kernel= supports width-3 stencils on 2/3 spatial axes only "
            f"(got width={width}, nsd={nsd}); drop kernel= for the plain "
            "path")
    spatial = tuple(u.shape[-nsd:])
    ub = u.reshape((-1,) + spatial)
    Cb = C.reshape((width ** nsd, -1) + spatial)
    return stencil_apply(Cb, ub, nsd).reshape(u.shape)


def stencil_diag(C: torch.Tensor, width: int = 3,
                 nsd: int | None = None) -> torch.Tensor:
    """Centre (diagonal) coefficient of an extracted stencil: the exact
    operator diagonal."""
    if nsd is None:
        nsd = C.ndim - 1
    h = (width - 1) // 2
    center = 0
    for _ in range(nsd):
        center = center * width + h
    return C[center]


def extract_verified(A: Callable, shape, width: int = 3,
                     nsd: int | None = None, probe=None, want=None,
                     device="cuda"):
    """:func:`extract_stencil` plus a one-probe defect check.

    probe/want: an already evaluated field and its image ``A(probe)``
    (skips one operator application); made here when omitted, from
    ``np.random.default_rng(0).standard_normal`` (the JAX package draws it
    from ``jax.random.key(0)``: other numbers, the same role).

    Returns ``(C, defect)``, ``defect`` the relative L2 mismatch of the
    stencil matvec against ``A`` on the probe: above ~1e-4 the operator is
    wider than ``width`` or not a stencil.
    """
    device = resolve_device(device, "extract_verified")
    shape = tuple(int(s) for s in shape)
    if nsd is None:
        nsd = len(shape)
    C = extract_stencil(A, shape, width=width, nsd=nsd, device=device)
    if probe is None:
        probe = torch.from_numpy(np.random.default_rng(0).standard_normal(
            shape).astype(np.float32)).to(device)
        want = None
    if want is None:
        want = A(probe)
    got = stencil_matvec(C, probe, width=width, nsd=nsd)
    defect = float(torch.linalg.norm(got - want)
                   / (torch.linalg.norm(want) + 1e-30))
    return C, defect


def assemble_stencil(residual_fn: Callable, shape, width: int = 3,
                     nsd: int | None = None, verify: bool = True,
                     rtol: float = 1e-4, device="cuda"):
    """Assemble an affine residual ``R(u) = A u - b`` into stencil form.

    Returns ``(matvec, b, C)`` with ``matvec(u) == A u`` through
    :func:`stencil_matvec` and ``b = -R(0)``. verify: raise ValueError when
    the stencil's defect on one random field exceeds ``rtol`` (an operator
    wider than ``width``, or not a stencil)."""
    device = resolve_device(device, "assemble_stencil")
    shape = tuple(int(s) for s in shape)
    if nsd is None:
        nsd = len(shape)
    b = -residual_fn(torch.zeros(shape, device=device))

    def A(u):
        return residual_fn(u) + b

    C, defect = extract_verified(A, shape, width=width, nsd=nsd,
                                 device=device)
    if verify and defect > rtol:
        raise ValueError(
            f"operator is not a width-{width} stencil on the trailing "
            f"{nsd} axes (relative defect {defect:.2e}); for deg-d "
            "elements pass width=2*deg+1, and for nonlocal operators "
            "use the matrix-free path")

    def matvec(u):
        return stencil_matvec(C, u, width=width, nsd=nsd)

    return matvec, b, C
