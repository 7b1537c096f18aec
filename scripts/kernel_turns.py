#!/usr/bin/env python3
"""Time K1 (the 2D stiffness action), K6 (the fused VMS residual), K5
(the 3D stiffness action), K2 (the resmin loss and gradient) and K3 (the
Ritz energy) against an earlier build of the same kernels, in turns, on one
CUDA card.

    python3 scripts/kernel_turns.py --parent DIR [--kernels K2,K3] [--out FILE]

DIR holds the sources of the version before the kernels were redesigned
(e.g. from ``git archive <commit> diffnet_tpu_torch/csrc``), with the C
interfaces they had then: for K1 ``poisson2d.cu``'s
``poisson_stiffness_action(u, nu, out, B, nrows, ncols, k1x, k2x, k1y,
k2y, stream)``, for K6 ``ns2d.cu``'s ``ns_vms_residual(u, v, p, fx, fy, r1,
r2, r3, B, ny, nx, has_f, c00, c01, c10, c11, 1/hx, 1/hy, W, W/hx, W/hy,
visco, Gxx, Gyy, diff, 1/(Gxx + Gyy), stream)``, for K5 ``poisson3d.cu``'s
``poisson_stiffness_action_3d(u, nu, out, B, nz, ny, nx, c00, c01, c10,
c11, wx2, wy2, wz2, stream)``, for K2 ``poisson2d.cu``'s
``poisson_resmin_loss_grad(u, nu, nf, nf_bstride, bc, bc_bstride, grad,
partials, B, nrows, ncols, k1x, k2x, k1y, k2y, stream)`` with
``poisson_resmin_loss_grad_partials(B, nrows, ncols)``, for K3 its
``poisson_energy(u, nu, f, partials, B, nrows, ncols, bf16, c1x, c2x, c3x,
c1y, c2y, c3y, cm, stream)`` with ``poisson_energy_partials(B, nrows,
ncols)``. ``--kernels`` (a comma list, K1, K6 and K5 by default) picks the
kernels; only their sources are built, with the port's nvcc flags, into
``DIR/earlier.so``, and only their entry points are bound.

It prints the card's name and power limit, both builds' ptxas lines,
then, as JSON lines: every strip length of the current kernels against
their plain versions (K1 in float32 and bf16, K6 with and without forcing,
K5 at ``chip_smoke.K5_SHAPES``, K2 with Nf and bc as shared planes and
per sample, K3 in float32 and bf16, both at ``chip_smoke.K2_K3_SHAPES``;
the run fails on a miss), the SASS instruction mix of K5, K2 and K3 in both
builds, and CUDA-event
times (``chip_smoke.cuda_ms``: 10 calls queued behind a spin kernel, median
of 20, the callables in turns) of the earlier kernel (twice, first and
last), the current one through its wrapper (the strip it picks) and at each
strip, at the timed shapes of ``chip_smoke.py`` and at the shapes most
main-path launches run at.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from diffnet_tpu_torch.ops import _build  # noqa: E402
from diffnet_tpu_torch.ops import ns_residual as k6  # noqa: E402
from diffnet_tpu_torch.ops import poisson_energy as k3  # noqa: E402
from diffnet_tpu_torch.ops import poisson_loss_grad as k2  # noqa: E402
from diffnet_tpu_torch.ops import poisson_residual as k1  # noqa: E402
from diffnet_tpu_torch.ops import poisson_residual_3d as k5  # noqa: E402

STRIPS = (31, 15, 10, 7, 5, 3, 2, 1)
K1_SHAPES = ((32, 512, 512), (1, 513, 513), (1, 257, 257), (1, 64, 64))
K6_SHAPES = ((8, 512), (8, 256), (1, 129), (1, 65))
K5_SHAPES = ((4, 64, 64, 64), (1, 128, 128, 128), (1, 129, 129, 129),
             (1, 65, 65, 65), (1, 17, 17, 17))
VISCO = 0.01
K2_K3_TIMED = ((32, 512, 512), (1, 513, 513), (8, 256, 256), (1, 64, 64))
SOURCES = {"K1": "poisson2d", "K6": "ns2d", "K5": "poisson3d",
           "K2": "poisson2d", "K3": "poisson2d"}
# kernel -> the mangled-name part of its CUDA function (for sass_mix)
SASS_NAMES = {"K5": "stiffness3d_kernel", "K2": "loss_grad_kernel",
              "K3": "energy_kernel"}


def earlier_consts(basis, visco):
    """The earlier K6's constants."""
    xi = np.asarray(basis.gp_1d, np.float64)
    W = float(np.asarray(basis.jxw, np.float64)[0])
    hx, hy = (float(h) for h in basis.h)
    cN = [((1.0 - x) / 2.0, (1.0 + x) / 2.0) for x in xi]
    Gxx, Gyy = 4.0 / hx**2, 4.0 / hy**2
    return (cN[0][0], cN[0][1], cN[1][0], cN[1][1], 1.0 / hx, 1.0 / hy,
            W, W / hx, W / hy, float(visco), Gxx, Gyy,
            36.0 * visco**2 * (Gxx**2 + Gyy**2), 1.0 / (Gxx + Gyy))


def build_earlier(src_dir: str, kernels) -> tuple[ctypes.CDLL, list[str]]:
    nvcc, log, objs = _build._nvcc(), "", []
    for name in dict.fromkeys(SOURCES[k] for k in kernels):
        obj = os.path.join(src_dir, f"{name}.o")
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", obj,
                            os.path.join(src_dir, f"{name}.cu")],
                           capture_output=True, text=True, check=True)
        log += r.stdout + r.stderr
        objs.append(obj)
    so = os.path.abspath(os.path.join(src_dir, "earlier.so"))
    subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", so, *objs],
                   capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(so)
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    if "K1" in kernels:
        lib.poisson_stiffness_action.argtypes = ([P, P, P, I, I, I]
                                                 + [F] * 4 + [P])
        lib.poisson_stiffness_action.restype = I
    if "K6" in kernels:
        lib.ns_vms_residual.argtypes = [P] * 8 + [I] * 4 + [F] * 14 + [P]
        lib.ns_vms_residual.restype = I
    if "K5" in kernels:
        lib.poisson_stiffness_action_3d.argtypes = ([P, P, P, I, I, I, I]
                                                    + [F] * 7 + [P])
        lib.poisson_stiffness_action_3d.restype = I
    if "K2" in kernels:
        lib.poisson_resmin_loss_grad.argtypes = ([P, P, P, LL, P, LL, P, P,
                                                  I, I, I] + [F] * 4 + [P])
        lib.poisson_resmin_loss_grad.restype = I
        lib.poisson_resmin_loss_grad_partials.argtypes = [I, I, I]
        lib.poisson_resmin_loss_grad_partials.restype = LL
    if "K3" in kernels:
        lib.poisson_energy.argtypes = [P] * 4 + [I] * 4 + [F] * 7 + [P]
        lib.poisson_energy.restype = I
        lib.poisson_energy_partials.argtypes = [I, I, I]
        lib.poisson_energy_partials.restype = LL
    return lib, [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]


SASS_OPS = ("FFMA", "FADD", "FMUL", "SHFL", "LDS", "STS", "LDG", "STG",
            "BAR", "BRA")


def sass_mix(so: str, kernel: str) -> dict:
    """Static SASS instruction counts (``cuobjdump -sass``) of the kernels
    in `so` whose mangled name contains `kernel`: all, fp32 (FFMA + FADD +
    FMUL) and the opcodes of SASS_OPS."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    ops, take = collections.Counter(), False
    for ln in text.splitlines():
        if "Function :" in ln:
            take = kernel in ln
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     ln)
        if take and m:
            ops[m.group(1)] += 1
    return {"all": sum(ops.values()),
            "fp32": ops["FFMA"] + ops["FADD"] + ops["FMUL"],
            **{op: ops[op] for op in SASS_OPS}}


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launched(status: int) -> None:
    if status != 0:
        raise RuntimeError(f"launch failed with CUDA error {status}")


def k1_at(lib, u, nu, tb, ty):
    """The current K1 at strip `ty` (through the C entry point)."""
    out = torch.empty_like(u)
    launched(lib.poisson_stiffness_action(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), *u.shape, ty,
        int(u.dtype == torch.bfloat16), *k1.stiffness_consts(tb.basis),
        stream()))
    return out


def k1_earlier(lib, u, nu, tb):
    out = torch.empty_like(u)
    launched(lib.poisson_stiffness_action(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), *u.shape,
        *k1.stiffness_consts(tb.basis), stream()))
    return out


def k6_at(lib, u, v, p, fx, fy, tb, ty):
    outs = [torch.empty_like(u) for _ in range(3)]
    has_f = fx is not None
    launched(lib.ns_vms_residual(
        u.data_ptr(), v.data_ptr(), p.data_ptr(),
        fx.data_ptr() if has_f else None, fy.data_ptr() if has_f else None,
        *(o.data_ptr() for o in outs), *u.shape, ty,
        int(has_f), *k6.ns_consts(tb.basis, VISCO), stream()))
    return outs


def k6_earlier(lib, u, v, p, tb):
    outs = [torch.empty_like(u) for _ in range(3)]
    B, n, _ = u.shape
    launched(lib.ns_vms_residual(
        u.data_ptr(), v.data_ptr(), p.data_ptr(), None, None,
        *(o.data_ptr() for o in outs), B, n, n, 0,
        *earlier_consts(tb.basis, VISCO), stream()))
    return outs


def k5_at(lib, u, nu, tb, tz):
    """The current K5 at strip `tz` (through the C entry point)."""
    out = torch.empty_like(u)
    launched(lib.poisson_stiffness_action_3d(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), *u.shape, tz,
        *k5.stiffness_consts_3d(tb.basis), stream()))
    return out


def k5_earlier(lib, u, nu, tb):
    out = torch.empty_like(u)
    launched(lib.poisson_stiffness_action_3d(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), *u.shape,
        *k5.stiffness_consts_3d(tb.basis), stream()))
    return out


def check_k5_strips(lib, dev, emit) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    bad = []
    for shape, aniso in cs.K5_SHAPES:
        tb = cs.basis_3d(shape, aniso, dev)
        u = torch.rand(shape, generator=g, device=dev)
        nu = torch.rand(shape, generator=g, device=dev) + 0.5
        ref = k5.stiffness_action_3d_plain(u, nu, tb)
        scale = max(1.0, float(ref.abs().max()))
        errs = {str(tz): float((k5_at(lib, u, nu, tb, tz) - ref).abs().max())
                for tz in k5.STRIPS}
        errs["wrapper"] = float((k5.stiffness_action_3d(u, nu, tb) - ref)
                                .abs().max())
        row = {"check": "K5", "shape": list(shape), "max_abs_err": errs,
               "limit": cs.FIELD_ATOL * scale}
        emit(row)
        if max(errs.values()) > cs.FIELD_ATOL * scale:
            bad.append(row)
    if bad:
        raise RuntimeError(f"K5 strips off the plain version: {bad}")


def time_k5(lib, old, dev, emit) -> None:
    g = torch.Generator(device=dev).manual_seed(3)
    for shape in K5_SHAPES:
        tb = cs.basis_3d(shape, False, dev)
        u = torch.rand(shape, generator=g, device=dev)
        nu = torch.rand(shape, generator=g, device=dev) + 0.5
        fns = {"earlier": lambda: k5_earlier(old, u, nu, tb),
               "wrapper": lambda: k5.stiffness_action_3d(u, nu, tb)}
        for tz in k5.STRIPS:
            fns[f"tz{tz}"] = lambda tz=tz: k5_at(lib, u, nu, tb, tz)
        fns["earlier_again"] = fns["earlier"]
        t = cs.cuda_ms(fns)
        emit({"time": "K5", "shape": list(shape), "ms": t,
              "strip": k5.strip_planes(*shape, _build.sm_count(dev)),
              "bound_ms": cs.bound("poisson_stiffness_action_3d", (u, nu, u),
                                   shape)["bound_ms"]})


def k2_earlier(lib, u, nu, Nf, bc, tb):
    """The earlier K2: (loss, grad)."""
    B, ny, nx = u.shape
    grad = torch.empty_like(u)
    partials = torch.empty(lib.poisson_resmin_loss_grad_partials(B, ny, nx),
                           device=u.device)
    launched(lib.poisson_resmin_loss_grad(
        u.data_ptr(), nu.data_ptr(), Nf.data_ptr(),
        ny * nx if Nf.dim() == 3 else 0, bc.data_ptr(),
        ny * nx if bc.dim() == 3 else 0, grad.data_ptr(), partials.data_ptr(),
        B, ny, nx, *k1.stiffness_consts(tb.basis), stream()))
    return partials.sum(), grad


def k3_earlier(lib, u, nu, f, tb):
    """The earlier K3: the energy in u's type."""
    B, ny, nx = u.shape
    partials = torch.empty(lib.poisson_energy_partials(B, ny, nx),
                           device=u.device)
    launched(lib.poisson_energy(
        u.data_ptr(), nu.data_ptr(), f.data_ptr(), partials.data_ptr(),
        B, ny, nx, int(u.dtype == torch.bfloat16),
        *k3.energy_consts(tb.basis), stream()))
    return (partials.sum() / (B * (ny - 1) * (nx - 1))).to(u.dtype)


def _k2_inputs(shape, g, dev, per_sample):
    B, ny, nx = shape
    u, nu, Nf = (torch.rand(shape, generator=g, device=dev)
                 for _ in range(3))
    bc = (torch.rand(shape if per_sample else (ny, nx), generator=g,
                     device=dev) > 0.9).float()
    bc[..., [0, -1], :] = 1
    bc[..., :, [0, -1]] = 1
    return u, nu + 0.5, Nf if per_sample else Nf[0].contiguous(), bc


def check_k2_k3(dev, emit) -> None:
    """Every tile height of the current K2 and K3, and their wrappers,
    against the plain versions at chip_smoke's K2_K3_SHAPES: K2 with Nf
    and bc shared by the batch and per sample, K3 in float32 and bf16."""
    g = torch.Generator(device=dev).manual_seed(4)
    bad = []
    for shape in cs.K2_K3_SHAPES:
        tb = cs.basis_for(shape[1], shape[2], False, dev)
        for per_sample in (False, True):
            u, nu, Nf, bc = _k2_inputs(shape, g, dev, per_sample)
            loss_p, grad_p = k2.resmin_loss_grad_plain(u, nu, Nf, bc, tb)
            runs = {str(ty): k2.loss_grad_at_strip(u, nu, Nf, bc, tb, ty)
                    for ty in k2.STRIPS}
            runs["wrapper"] = k2.resmin_loss_grad(u, nu, Nf, bc, tb)
            gref = float(grad_p.abs().max())
            lref = abs(float(loss_p))
            errs = {k: (abs(float(loss) - lref) / max(lref, 1e-30),
                        float((grad - grad_p).abs().max()) / max(gref, 1e-30))
                    for k, (loss, grad) in runs.items()}
            row = {"check": "K2", "shape": list(shape),
                   "per_sample": per_sample, "loss_rel_err":
                   max(e[0] for e in errs.values()), "grad_rel_err":
                   max(e[1] for e in errs.values())}
            emit(row)
            # at 1 x 2^2 every node is masked: loss and gradient exactly 0
            if any(le > cs.SCALAR_RTOL * (lref > 0) or
                   ge > cs.GRAD_RTOL * (gref > 0)
                   for le, ge in errs.values()):
                bad.append((row, errs))
        u, nu, f, _ = _k2_inputs(shape, g, dev, True)
        for dt, tol in ((torch.float32, cs.SCALAR_RTOL),
                        (torch.bfloat16, cs.BF16_ATOL)):
            a, b, c = u.to(dt), nu.to(dt), f.to(dt)
            ref = float(k3.energy_plain(a, b, c, tb))
            scale = abs(ref) if dt == torch.float32 else max(1.0, abs(ref))
            errs = {str(ty): abs(float(k3.energy_at_strip(a, b, c, tb, ty))
                                 - ref) for ty in k3.STRIPS}
            errs["wrapper"] = abs(float(k3.energy(a, b, c, tb)) - ref)
            row = {"check": "K3", "shape": list(shape), "dtype": str(dt),
                   "abs_err": max(errs.values()), "limit": tol * scale}
            emit(row)
            if max(errs.values()) > tol * scale:
                bad.append((row, errs))
    if bad:
        raise RuntimeError(f"K2 / K3 off their plain versions: {bad}")


def time_k2_k3(old, dev, emit) -> None:
    g = torch.Generator(device=dev).manual_seed(5)
    sms = _build.sm_count(dev)
    for shape in K2_K3_TIMED:
        tb = cs.basis_for(shape[1], shape[2], False, dev)
        # Nf per sample and bc shared, as slice B gives them
        u, nu, f, bc = _k2_inputs(shape, g, dev, True)
        Nf, bc = f, bc[0].contiguous()
        ub, nub, fb = u.bfloat16(), nu.bfloat16(), f.bfloat16()
        grad = torch.empty_like(u)
        fns = {"earlier": lambda: k2_earlier(old, u, nu, Nf, bc, tb),
               "wrapper": lambda: k2.resmin_loss_grad(u, nu, Nf, bc, tb)}
        for ty in k2.STRIPS:
            fns[f"ty{ty}"] = lambda ty=ty: k2.loss_grad_at_strip(
                u, nu, Nf, bc, tb, ty)
        fns["earlier_again"] = fns["earlier"]
        emit({"time": "K2", "shape": list(shape), "ms": cs.cuda_ms(fns),
              "strip": k2.strip_rows(*shape, sms),
              "bound_ms": cs.bound("poisson_resmin_loss_grad",
                                   (u, nu, Nf, bc, grad), shape)["bound_ms"]})
        fns = {"earlier": lambda: k3_earlier(old, u, nu, f, tb),
               "earlier_bf16": lambda: k3_earlier(old, ub, nub, fb, tb),
               "wrapper": lambda: k3.energy(u, nu, f, tb),
               "wrapper_bf16": lambda: k3.energy(ub, nub, fb, tb)}
        for ty in k3.STRIPS:
            fns[f"ty{ty}"] = lambda ty=ty: k3.energy_at_strip(u, nu, f, tb,
                                                              ty)
            fns[f"bf16_ty{ty}"] = lambda ty=ty: k3.energy_at_strip(
                ub, nub, fb, tb, ty)
        fns["earlier_again"] = fns["earlier"]
        fns["earlier_bf16_again"] = fns["earlier_bf16"]
        emit({"time": "K3", "shape": list(shape), "ms": cs.cuda_ms(fns),
              "strip": k3.strip_rows(*shape, sms),
              "bound_ms": cs.bound("poisson_energy", (u, nu, f),
                                   shape)["bound_ms"],
              "bound_ms_bf16": cs.bound("poisson_energy", (ub, nub, fb),
                                        shape)["bound_ms"]})


def check_strips(lib, dev, emit) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    bad = []
    for B, ny, nx in ((2, 33, 33), (3, 129, 257), (1, 2, 2), (1, 100, 77),
                      (1, 513, 513), (32, 512, 512)):
        tb = cs.basis_for(ny, nx, True, dev)
        u = torch.rand((B, ny, nx), generator=g, device=dev)
        nu = torch.rand((B, ny, nx), generator=g, device=dev) + 0.5
        row = {"check": "K1", "shape": [B, ny, nx]}
        for dt, tol in ((torch.float32, cs.FIELD_ATOL),
                        (torch.bfloat16, cs.BF16_ATOL)):
            a, b = u.to(dt), nu.to(dt)
            ref = k1.stiffness_action_plain(a, b, tb).float()
            scale = max(1.0, float(ref.abs().max()))
            errs = [float((k1_at(lib, a, b, tb, ty).float() - ref).abs()
                          .max()) for ty in STRIPS]
            row[str(dt)] = max(errs)
            if max(errs) > tol * scale:
                bad.append(row)
        emit(row)
    for B, n, with_f in ((1, 2, False), (1, 97, False), (2, 40, True),
                         (1, 129, False), (8, 512, False)):
        tb = cs.basis_for(n, n, True, dev)
        u, v, p, fx, fy = (torch.rand((B, n, n), generator=g, device=dev)
                           for _ in range(5))
        if not with_f:
            fx = fy = None
        ref = k6.ns_vms_residual_plain(u, v, p, fx, fy, tb, VISCO)
        err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                  for ty in STRIPS
                  for a, b in zip(k6_at(lib, u, v, p, fx, fy, tb, ty), ref))
        row = {"check": "K6", "shape": [B, n, n], "forcing": with_f,
               "rel_err": err}
        emit(row)
        if err > cs.K6_ATOL:
            bad.append(row)
    if bad:
        raise RuntimeError(f"strips off their plain versions: {bad}")


def time_k1(lib, old, dev, emit) -> None:
    g = torch.Generator(device=dev).manual_seed(1)
    for shape in K1_SHAPES:
        tb = cs.basis_for(shape[1], shape[2], False, dev)
        u = torch.rand(shape, generator=g, device=dev)
        nu = torch.rand(shape, generator=g, device=dev) + 0.5
        ub, nub = u.bfloat16(), nu.bfloat16()
        fns = {"earlier": lambda: k1_earlier(old, u, nu, tb),
               "wrapper": lambda: k1.stiffness_action(u, nu, tb),
               "wrapper_bf16": lambda: k1.stiffness_action(ub, nub, tb)}
        for ty in STRIPS:
            fns[f"ty{ty}"] = lambda ty=ty: k1_at(lib, u, nu, tb, ty)
            fns[f"bf16_ty{ty}"] = lambda ty=ty: k1_at(lib, ub, nub, tb, ty)
        fns["earlier_again"] = fns["earlier"]
        t = cs.cuda_ms(fns)
        emit({"time": "K1", "shape": list(shape), "ms": t,
              "strip": k1.strip_rows(*shape, _build.sm_count(dev)),
              "bound_ms": cs.bound("poisson_stiffness_action",
                                   (u, nu, u), shape)["bound_ms"],
              "bound_ms_bf16": cs.bound("poisson_stiffness_action",
                                        (ub, nub, ub), shape)["bound_ms"]})


def time_k6(lib, old, dev, emit) -> None:
    g = torch.Generator(device=dev).manual_seed(2)
    for B, n in K6_SHAPES:
        tb = cs.basis_for(n, n, False, dev)
        u, v, p = (torch.rand((B, n, n), generator=g, device=dev)
                   for _ in range(3))
        fns = {"earlier": lambda: k6_earlier(old, u, v, p, tb),
               "wrapper": lambda: k6.ns_vms_residual(u, v, p, None, None,
                                                     tb, VISCO)}
        for ty in STRIPS:
            fns[f"ty{ty}"] = lambda ty=ty: k6_at(lib, u, v, p, None, None,
                                                 tb, ty)
        fns["earlier_again"] = fns["earlier"]
        t = cs.cuda_ms(fns)
        emit({"time": "K6", "shape": [B, n, n], "ms": t,
              "strip": k6.strip_rows(B, n, n, _build.sm_count(dev)),
              "bound_ms": cs.bound("ns_vms_residual", (u, v, p) * 2,
                                   (B, n, n))["bound_ms"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier kernels' sources")
    ap.add_argument("--kernels", default="K1,K6,K5",
                    help="comma list of K1, K6, K5, K2, K3 (default: the "
                         "first three)")
    ap.add_argument("--out", help="also write every JSON line to this file")
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    cs.phase_device(dev)
    rows = []

    def emit(obj):
        rows.append(obj)
        print(json.dumps(obj), flush=True)

    so, log = _build.build()
    lib = _build.load_library()
    kernels = [k.strip() for k in args.kernels.split(",")]
    if not set(kernels) <= set(SOURCES):
        ap.error(f"--kernels takes {', '.join(SOURCES)}")
    old, old_log = build_earlier(args.parent, kernels)
    emit({"ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling" in ln],
          "ptxas_earlier": old_log})
    for kern in (k for k in kernels if k in SASS_NAMES):
        emit({f"sass_{kern}": sass_mix(str(so), SASS_NAMES[kern]),
              f"sass_{kern}_earlier": sass_mix(
                  os.path.join(args.parent, "earlier.so"),
                  SASS_NAMES[kern])})
    if "K1" in kernels or "K6" in kernels:
        check_strips(lib, dev, emit)
    if "K5" in kernels:
        check_k5_strips(lib, dev, emit)
    if "K2" in kernels or "K3" in kernels:
        check_k2_k3(dev, emit)
    if "K1" in kernels:
        time_k1(lib, old, dev, emit)
    if "K6" in kernels:
        time_k6(lib, old, dev, emit)
    if "K5" in kernels:
        time_k5(lib, old, dev, emit)
    if "K2" in kernels or "K3" in kernels:
        time_k2_k3(old, dev, emit)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
