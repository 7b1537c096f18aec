"""K6: the fused VMS Navier-Stokes residual of nodal (u, v, p).

Replaces the TPU kernel ``diffnet_tpu/ops/ns_residual.py``
(``_ns_fwd_impl`` / ``_ns_fwd_bs``, body ``_strip_accs``): in one pass over
the fields it evaluates u, v, p (and the optional nodal forcing fx, fy) at
the 2x2 Gauss points of every bilinear element, forms the VMS stabilisation
(tau_m and tau_c from the element metric, advection detached), the cross,
Reynolds-stress, PSPG and grad-div terms, and assembles the three
residuals R1, R2 (momentum) and R3 (continuity) into the nodes. Deg 1,
2x2 Gauss, square ``[B, n, n]`` float32 fields, visco > 0; Dirichlet rows
are the caller's concern (``pde.flow.StokesNSBase.calc_residuals``). The
split route (the residual over a mesh's 'space' axis, JAX's GSPMD path)
reaches the same kernel through :func:`ns_vms_residual_rows_fused`, which
takes a halo'd row block ``[B, n_loc + 1 or 2, nx]`` of a square grid and
the global grid's basis.

The element body is the JAX package's sum-factorised algebra: for deg 1,
d/dx of a field takes one value per y Gauss index and d/dy one per x
index, the N values reuse the 1D x-interpolations, and the integrands
accumulate into eight projection partials per residual (A: the N part
summed over gx, X: the dx part summed over gx, Y: the dy part summed over
gy) before a 1D projection tail gives the element's four corner values of
each residual.

What bounds it on the card: instruction issue. At 8 x 512^2 it moves u, v,
p in and R1-R3 out, 24 B a node (50.3 MB, 15.0 us at 3.35 TB/s), against
532 fp32 operations an element in the algorithm and 9 a node (FMA counted
as two; 1.11 GFLOP, 16.6 us at 67 TFLOP/s): the two floors nearly tie, and
the fp32 floor assumes all-FMA code. The first kernel (a block of 32 x 8
elements staged in shared memory, the corner values through shared memory,
1.18 element bodies an output node) ran at 0.0662 ms there on an H100
(700 W), 25% of that floor (PERF.md). The kernel (``csrc/ns2d.cu``) now
gives each block four warps stacked in y, each writing 31 node columns
and walking a strip of ``strip_rows`` element rows: each lane walks down a
column of elements, computes each once from node rows it loads straight
into registers, carries the bottom-corner sums down the column and takes
its neighbour's corner sums by shuffle; only a strip's last sums pass to
the warp below through shared memory, after the block's one barrier. The
strip is long where the grid fills the card and one element row where it
does not (a 129^2 grid). The body folds each
symmetric Gauss pair into sum/difference form (``tests/test_torch_flow.py``
holds a float64 transcription of it to the plain version). No atomics, the
same result on every run; the TPU strips, VMEM scratch and DMA semaphores
are not carried over.

``ns_vms_residual_fused`` is differentiable in both modes, as the JAX op
(a ``custom_jvp`` whose tangent runs the XLA path): its forward is the
kernel, its ``jvp`` rule the tangent of :func:`ns_vms_residual_plain`
(:func:`ns_vms_residual_plain_jvp`), so ``torch.func.jvp`` and
``torch.autograd.forward_ad`` give the Jacobian action that Newton-Krylov
needs, and its ``backward`` the VJP of the same plain version, which is
the transpose JAX takes of that tangent.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fem
from ..core.quadrature import FEMBasis
from ._build import check, load_library, sm_count
from .poisson_residual import check_fields, require_cuda

__all__ = ["calc_tau", "ns_vms_residual", "ns_vms_residual_fused",
           "ns_vms_residual_rows_fused", "ns_vms_residual_plain",
           "ns_vms_residual_plain_jvp", "vms_residuals"]

# Launches of the CUDA kernel (a plain count; callers reset it to 0).
launches = 0

# The kernel's tiling (csrc/ns2d.cu): a block is WARPS warps stacked in y,
# each writing COLS node columns and walking a strip of element rows, one
# of STRIPS long. On an H100, 7 rows are fastest at 8 x 512^2, 5 at
# 8 x 256^2 (where 7 leave the SMs 22 warps each) and one row a lane on a
# 129^2 grid (PERF.md).
COLS = 31
WARPS = 4
STRIPS = (7, 5, 3, 1)
MIN_WARPS_PER_SM = 24


def calc_tau(h, u, v, visco):
    """VMS stabilisation parameters at the Gauss points, the advective
    field detached (JAX's ``stop_gradient``: no gradient and no tangent
    flows through tau). `h` is a scalar or an ``(hx, hy)`` pair."""
    hx, hy = (h, h) if np.isscalar(h) else h
    u = u.detach()
    v = v.detach()
    Gxx = 4.0 / hx**2
    Gyy = 4.0 / hy**2
    adv_part = Gxx * u**2 + Gyy * v**2
    diff_part = 36.0 * visco**2 * (Gxx**2 + Gyy**2)
    temp = torch.sqrt(adv_part + diff_part)
    return 1.0 / temp, temp / (Gxx + Gyy)


def ns_consts(basis: FEMBasis, visco: float) -> tuple[float, ...]:
    """The kernel's constants (``csrc/ns2d.cu``'s ``NSConsts``): with p, q
    the 1D shape values at the first Gauss point (p + q = 1), h = (p - q)/2
    and W the equal JxW of the four Gauss points: ``h, h^2, -1/(2 hx),
    h/hx, -1/(2 hy), h/hy``; visco; ``Gxx = 4/hx^2, Gyy = 4/hy^2``; the
    diffusive part of tau's metric ``36 visco^2 (Gxx^2 + Gyy^2)``;
    ``1 / (Gxx + Gyy)``; ``W/4, W h, W h^2, W/(2 hx), W/(2 hy), W h/hx,
    W h/hy``."""
    if not (basis.deg == 1 and basis.nsd == 2 and basis.ngp_1d == 2):
        raise ValueError("the fused NS kernel supports deg-1 2D with 2x2 "
                         "Gauss points only")
    xi = np.asarray(basis.gp_1d, np.float64)
    jxw = np.asarray(basis.jxw, np.float64)
    W = float(jxw[0])
    if not np.allclose(jxw, W):
        raise ValueError("2x2 Gauss points must have equal JxW")
    hx, hy = (float(h) for h in basis.h)
    h = -float(xi[0]) / 2.0     # ((1 - xi) - (1 + xi)) / 4
    Gxx, Gyy = 4.0 / hx**2, 4.0 / hy**2
    return (h, h * h, -0.5 / hx, h / hx, -0.5 / hy, h / hy, float(visco),
            Gxx, Gyy, 36.0 * visco**2 * (Gxx**2 + Gyy**2), 1.0 / (Gxx + Gyy),
            W / 4.0, W * h, W * h * h, W / (2.0 * hx), W / (2.0 * hy),
            W * h / hx, W * h / hy)


def strip_rows(B: int, ny: int, nx: int, sms: int) -> int:
    """Element rows a warp walks for a ``[B, ny, nx]`` launch on `sms` SMs:
    the longest strip whose launch still gives each SM ``MIN_WARPS_PER_SM``
    warps, else one element row a lane."""
    cols = -(-nx // COLS)
    for ty in STRIPS:
        blocks = B * cols * -(-ny // (WARPS * ty - 1))
        if blocks * WARPS >= MIN_WARPS_PER_SM * sms:
            return ty
    return STRIPS[-1]


def _gauss_values(u, v, p, fx, fy, basis: fem.BasisTables):
    """u, v, p (N, dx, dy, and d2x, d2y above deg 1) and the forcing (N;
    zero for None) at the Gauss points."""
    quants = (("N", "dx", "dy") if basis.deg == 1
              else ("N", "dx", "dy", "d2x", "d2y"))
    allgp = fem.gp_eval_stacked(torch.stack([u, v, p]), basis, quants)
    ug, vg, pg = ({q: allgp[k, ..., i, :] for i, q in enumerate(quants)}
                  for k in range(3))
    if fx is None:
        f1 = f2 = torch.zeros_like(ug["N"])
    else:
        f1 = fem.gp_eval(fx, basis, ("N",))["N"]
        f2 = fem.gp_eval(fy, basis, ("N",))["N"]
    return ug, vg, pg, f1, f2


def _momentum(ug, vg, pg, f1, f2, visco, deg):
    """(div, adv1, adv2, res1, res2) at the Gauss points; at deg 1 the
    Laplacian drops out (the basis second derivatives vanish). Linear in
    each field's values, so it also gives the tangents' linear parts."""
    div = ug["dx"] + vg["dy"]
    adv1 = ug["N"] * ug["dx"] + vg["N"] * ug["dy"]
    adv2 = ug["N"] * vg["dx"] + vg["N"] * vg["dy"]
    res1 = adv1 + pg["dx"] - f1
    res2 = adv2 + pg["dy"] - f2
    if deg != 1:
        res1 = res1 - visco * (ug["d2x"] + ug["d2y"])
        res2 = res2 - visco * (vg["d2x"] + vg["d2y"])
    return div, adv1, adv2, res1, res2


def ns_vms_residual_plain(u, v, p, fx, fy, basis: fem.BasisTables,
                          visco: float):
    """The three unmasked assembled VMS residuals in plain torch (any
    device, any degree): the counterpart of JAX's ``ns_vms_residual_xla``
    and the kernel's reference. None forcing means zero."""
    return vms_residuals(*_gauss_values(u, v, p, fx, fy, basis), basis,
                         visco, u.shape[-2:])


def vms_residuals(ug, vg, pg, f1, f2, basis: fem.BasisTables, visco: float,
                  n_shape):
    """The three unmasked assembled VMS residuals on `n_shape` nodes from
    the Gauss-point values of u, v, p (dicts of N, dx, dy, and d2x, d2y
    above deg 1) and of the forcing f1, f2 (anything that broadcasts)."""
    uN, ux, uy = ug["N"], ug["dx"], ug["dy"]
    vN, vx, vy = vg["N"], vg["dx"], vg["dy"]
    pN = pg["N"]
    div, adv1, adv2, res1, res2 = _momentum(ug, vg, pg, f1, f2, visco,
                                            basis.deg)
    taum, tauc = calc_tau(basis.basis.h, uN, vN, visco)

    def asm(terms):
        return fem.galerkin_project_multi(terms, basis, n_shape)

    R1 = asm([(adv1 - f1 - taum * (res1 * ux + res2 * uy), "N"),
              (visco * ux - pN + taum * uN * res1
               - taum**2 * res1 * res1 + tauc * div, "dx"),
              (visco * uy + taum * vN * res1 - taum**2 * res1 * res2, "dy")])
    R2 = asm([(adv2 - f2 - taum * (res1 * vx + res2 * vy), "N"),
              (visco * vx + taum * uN * res2 - taum**2 * res2 * res1, "dx"),
              (visco * vy - pN + taum * vN * res2
               - taum**2 * res2 * res2 + tauc * div, "dy")])
    R3 = asm([(div, "N"), (taum * res1, "dx"), (taum * res2, "dy")])
    return R1, R2, R3


def ns_vms_residual_plain_jvp(primals, tangents, basis: fem.BasisTables,
                              visco: float):
    """The tangent of :func:`ns_vms_residual_plain` at ``primals = (u, v,
    p[, fx, fy])`` along `tangents` (the same layout; None for zero), what
    ``torch.func.jvp`` of it gives, written out. tau is detached, so it
    carries no tangent, and every integrand's tangent is linear in the
    tangents' Gauss-point values. No nested forward AD, so the rule also
    runs under ``torch.autograd.forward_ad``, which refuses a nested
    level."""
    u, v, p, fx, fy = (tuple(primals) + (None, None))[:5]
    tangents = tuple(torch.zeros_like(x) if t is None else t
                     for x, t in zip(primals, tangents))
    du, dv, dp, dfx, dfy = (tangents + (None, None))[:5]
    ug, vg, pg, f1, f2 = _gauss_values(u, v, p, fx, fy, basis)
    dug, dvg, dpg, df1, df2 = _gauss_values(du, dv, dp, dfx, dfy, basis)
    uN, ux, uy = ug["N"], ug["dx"], ug["dy"]
    vN, vx, vy = vg["N"], vg["dx"], vg["dy"]
    duN, dux, duy = dug["N"], dug["dx"], dug["dy"]
    dvN, dvx, dvy = dvg["N"], dvg["dx"], dvg["dy"]
    _, _, _, res1, res2 = _momentum(ug, vg, pg, f1, f2, visco, basis.deg)
    ddiv = dux + dvy
    dadv1 = duN * ux + uN * dux + dvN * uy + vN * duy
    dadv2 = duN * vx + uN * dvx + dvN * vy + vN * dvy
    dres1 = dadv1 + dpg["dx"] - df1
    dres2 = dadv2 + dpg["dy"] - df2
    if basis.deg != 1:
        dres1 = dres1 - visco * (dug["d2x"] + dug["d2y"])
        dres2 = dres2 - visco * (dvg["d2x"] + dvg["d2y"])
    taum, tauc = calc_tau(basis.basis.h, uN, vN, visco)
    t2 = taum**2

    def asm(terms):
        return fem.galerkin_project_multi(terms, basis, u.shape[-2:])

    dR1 = asm([(dadv1 - df1 - taum * (dres1 * ux + res1 * dux
                                      + dres2 * uy + res2 * duy), "N"),
               (visco * dux - dpg["N"] + taum * (duN * res1 + uN * dres1)
                - 2.0 * t2 * res1 * dres1 + tauc * ddiv, "dx"),
               (visco * duy + taum * (dvN * res1 + vN * dres1)
                - t2 * (dres1 * res2 + res1 * dres2), "dy")])
    dR2 = asm([(dadv2 - df2 - taum * (dres1 * vx + res1 * dvx
                                      + dres2 * vy + res2 * dvy), "N"),
               (visco * dvx + taum * (duN * res2 + uN * dres2)
                - t2 * (dres2 * res1 + res2 * dres1), "dx"),
               (visco * dvy - dpg["N"] + taum * (dvN * res2 + vN * dres2)
                - 2.0 * t2 * res2 * dres2 + tauc * ddiv, "dy")])
    dR3 = asm([(ddiv, "N"), (taum * dres1, "dx"), (taum * dres2, "dy")])
    return dR1, dR2, dR3


def _validate(op, u, v, p, fx, fy, basis, visco, square=True
              ) -> tuple[float, ...]:
    """What the kernel takes (and JAX's fused op checks; `square`: its
    square fields, which the split route's row blocks are not); returns
    the kernel's constants."""
    if (fx is None) != (fy is None):
        raise ValueError(f"{op}: fx and fy must both be given or both None")
    fields = {"v": v, "p": p}
    if fx is not None:
        fields.update(fx=fx, fy=fy)
    check_fields(op, u, **fields)
    if not visco > 0.0:
        # tau = 1/sqrt(...) is inf where the metric's diffusive part is 0
        raise ValueError(f"{op}: visco must be > 0, got {visco}")
    if square and u.shape[1] != u.shape[2]:
        raise ValueError(f"{op}: the kernel needs square fields (ny == nx, "
                         f"as the JAX op), got {tuple(u.shape[1:])}")
    # raises on deg != 1 or another quadrature
    return ns_consts(basis.basis, visco)


def ns_vms_residual(u, v, p, fx, fy, basis: fem.BasisTables, visco: float,
                    square: bool = True):
    """(R1, R2, R3): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises. Not differentiable (see
    :func:`ns_vms_residual_fused`). ``square=False`` takes a row block of
    a square grid (the split route's entry; `basis` the grid's)."""
    global launches
    op = "ns_vms_residual"
    consts = _validate(op, u, v, p, fx, fy, basis, visco, square)
    if u.device.type == "cpu":
        return ns_vms_residual_plain(u, v, p, fx, fy, basis, visco)
    require_cuda(op, u)
    B, ny, nx = u.shape
    ty = strip_rows(B, ny, nx, sm_count(u.device))
    if -(-ny // (WARPS * ty - 1)) > 65535:
        raise ValueError(f"{op}: {-(-ny // (WARPS * ty - 1))} blocks of "
                         f"{WARPS * ty - 1} rows exceed the grid limit 65535")
    lib = load_library()
    outs = [torch.empty_like(u) for _ in range(3)]
    has_f = fx is not None
    status = lib.ns_vms_residual(
        u.data_ptr(), v.data_ptr(), p.data_ptr(),
        fx.data_ptr() if has_f else None, fy.data_ptr() if has_f else None,
        *(o.data_ptr() for o in outs), B, ny, nx, ty, int(has_f), *consts,
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, op)
    launches += 1
    return tuple(outs)


class _NSVMSResidual(torch.autograd.Function):
    """Forward: the dispatch. Forward mode: the tangent of the plain
    version. Reverse mode: the VJP of the plain version, recomputed."""

    @staticmethod
    def forward(u, v, p, fx, fy, basis, visco, square):
        return ns_vms_residual(u, v, p, fx, fy, basis, visco, square)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, v, p, fx, fy, basis, visco, _ = inputs
        ctx.basis, ctx.visco = basis, visco
        xs = (u, v, p) if fx is None else (u, v, p, fx, fy)
        ctx.save_for_backward(*xs)
        ctx.save_for_forward(*xs)

    @staticmethod
    def jvp(ctx, du, dv, dp, dfx, dfy, _basis, _visco, _square):
        return ns_vms_residual_plain_jvp(ctx.saved_tensors,
                                         (du, dv, dp, dfx, dfy), ctx.basis,
                                         ctx.visco)

    @staticmethod
    def backward(ctx, g1, g2, g3):
        xs = ctx.saved_tensors

        def plain(u, v, p, fx=None, fy=None):
            return ns_vms_residual_plain(u, v, p, fx, fy, ctx.basis,
                                         ctx.visco)

        _, vjp = torch.func.vjp(plain, *xs)
        grads = vjp((g1, g2, g3))
        if len(grads) == 3:
            grads = grads + (None, None)
        return grads + (None, None, None)


def ns_vms_residual_fused(u, v, p, fx, fy, basis: fem.BasisTables,
                          visco: float):
    """Differentiable (R1, R2, R3), the assembled unmasked VMS residuals of
    nodal ``[B, n, n]`` (u, v, p) with optional nodal forcing (fx, fy) (None
    for zero): the kernel forward, the plain version's tangent and VJP."""
    return _NSVMSResidual.apply(u, v, p, fx, fy, basis, visco, True)


def ns_vms_residual_rows_fused(u, v, p, fx, fy, basis: fem.BasisTables,
                               visco: float):
    """:func:`ns_vms_residual_fused` on a halo'd row block ``[B, rows, nx]``
    of a square grid whose basis is `basis`: the split route's entry (the
    rows of the result that the block's halo cuts short are the caller's
    to drop). A CUDA tensor runs the kernel or raises."""
    return _NSVMSResidual.apply(u, v, p, fx, fy, basis, visco, False)
