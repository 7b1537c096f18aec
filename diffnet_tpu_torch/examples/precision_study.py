"""Mixed-precision policy study: what does bf16 buy (and cost) on the
framework's hot path? (port of ``scripts/precision_study.py``)

Measures, on the device ``--device`` names (the card by default):

1. residual accuracy: rel-L2 of the assembled Poisson Galerkin residual
   computed with bf16 fields (float32 accumulation, the library policy)
   against the float32 result, at 128^2 and 512^2;
2. end-to-end solution accuracy: Poisson 64^2 MMS resmin solved by LBFGS
   under three policies (all-f32, bf16-residual with float32 master
   params and loss, bf16-accum with the loss reduced in bf16); final
   rel-L2 against the exact solution; 2b. the same at 32^2 with Adam
   (on the card each loss-and-gradient evaluation of section 2, and each
   Adam step after the first, is one CUDA graph replay);
3. throughput: the residual at ``DIFFNET_BENCH_SIZE`` (default 512^2, bs
   8) in float32 and bf16, elements/s = bs (n - 1)^2 / s (10 timed
   calls after 3).

The library policy is the port's ``core/fem.py`` contractions in the
field type (``torch.matmul``; XLA's ``preferred_element_type=float32``
in the JAX package). On the card the study turns
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
off, so a bf16 matmul accumulates in float32 there too, and restores
the setting when it ends. With
``--fused-kernels`` sections 1 and 3 also measure K1's route
(``poisson_residual_fused``: bf16 loads, float32 arithmetic, one rounding
on the store; the load vector projected by the library policy).

Writes ``--out`` (default ``runs/precision/MIXED_PRECISION.md``):

    python -m diffnet_tpu_torch.examples.precision_study --fused-kernels
    python -m diffnet_tpu_torch.examples.precision_study --throughput-only
"""

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from ._common import add_port_flags, device_label, device_of

ROUTES = ("library", "k1")   # the contraction residual, K1's route


def _basis(n, dev):
    from ..core import fem
    from ..core.quadrature import make_basis

    return fem.BasisTables(make_basis(2, 1, h=(1 / (n - 1),) * 2)).to(dev)


def residual(u, nu, f_gp, basis, n, bc):
    from ..core import fem

    gp = fem.gp_eval(u, basis, ("dx", "dy"))
    nu_gp = fem.gp_eval(nu, basis, ("N",))["N"]
    R = fem.galerkin_project_multi(
        [(nu_gp * gp["dx"], "dx"), (nu_gp * gp["dy"], "dy"),
         (-f_gp, "N")], basis, (n, n))
    return torch.where(bc > 0.5, torch.zeros_like(R), R)


def residual_k1(u, nu, f_gp, basis, n, bc):
    """:func:`residual` through K1: the load vector projected by the
    library policy, then ``poisson_residual_fused``."""
    from ..core import fem
    from ..ops import poisson_residual_fused

    Nf = fem.galerkin_project(f_gp, basis, "N", (n, n)).contiguous()
    return poisson_residual_fused(u, nu, Nf, bc, basis)


def _route(route):
    return {"library": residual, "k1": residual_k1}[route]


def _fields(n, bs, dev):
    rng = np.random.default_rng(0)
    u = rng.random((bs, n, n)).astype(np.float32)
    nu = rng.random((bs, n, n)).astype(np.float32)
    f = rng.random((bs, n - 1, n - 1, 4)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (u, nu, f)]


def accuracy_vs_f32(n, bs=2, device="cuda", route="library"):
    dev = torch.device(device)
    basis = _basis(n, dev)
    u, nu, f = _fields(n, bs, dev)
    bc = torch.zeros((n, n), device=dev)
    bc[0, :] = 1.0
    fn = _route(route)
    with torch.no_grad():
        r32 = fn(u, nu, f, basis, n, bc)
        r16 = fn(u.bfloat16(), nu.bfloat16(), f.bfloat16(), basis, n, bc)
    num = float(torch.linalg.vector_norm((r16.float() - r32).ravel()))
    den = float(torch.linalg.vector_norm(r32.ravel()))
    return num / den


def _mms_problem(n, dev):
    from ..core import fem

    basis = _basis(n, dev)
    x = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(x, x)
    exact = np.sin(np.pi * xx) * np.sin(np.pi * yy)
    xg, yg = fem.gp_coords(basis.basis, (n, n))
    f_gp = (2 * np.pi**2 * np.sin(np.pi * xg) * np.sin(np.pi * yg)
            ).astype(np.float32)[None]
    bc = np.zeros((n, n), np.float32)
    bc[[0, -1], :] = 1.0
    bc[:, [0, -1]] = 1.0
    return (basis, torch.from_numpy(exact.astype(np.float32))[None].to(dev),
            torch.from_numpy(f_gp).to(dev), torch.from_numpy(bc).to(dev))


def _rel_l2_exact(u, exact, bc, basis):
    from ..core import fem

    with torch.no_grad():
        uf = torch.where(bc > 0.5, torch.zeros_like(u), u).float()
        err = fem.gp_eval(uf - exact, basis, ("N",))["N"]
        ex = fem.gp_eval(exact, basis, ("N",))["N"]
        jxw = basis.jxw(torch.float32)
        return float(torch.sqrt(torch.sum(jxw * err**2)
                                / torch.sum(jxw * ex**2)))


def solve_mms(n, policy, steps=300, device="cuda"):
    """Poisson MMS resmin solved with LBFGS (the production direct-solve
    optimizer; float32 master params): `steps` updates of
    :class:`~diffnet_tpu_torch.train.lbfgs.ZoomLBFGS`, the port of the
    ``optax.lbfgs()`` that the JAX study runs (memory 10, the zoom line
    search, which takes its last trial where none lowers the bf16 loss).
    policy:
      f32           — everything float32
      bf16-residual — bf16 fields/assembly, float32 contraction
                      accumulation (the library policy) and float32 loss
      bf16-accum    — as above but the loss reduction also in bf16"""
    from ..train.krylov import CudaGraphed
    from ..train.lbfgs import ZoomLBFGS

    dev = torch.device(device)
    basis, exact, f32_gp, bc = _mms_problem(n, dev)
    nu32 = torch.ones((1, n, n), device=dev)
    comp_dt = torch.float32 if policy == "f32" else torch.bfloat16

    def loss(u_master):
        u = torch.where(bc > 0.5, torch.zeros_like(u_master),
                        u_master).to(comp_dt)
        R = residual(u, nu32.to(comp_dt), f32_gp.to(comp_dt), basis, n, bc)
        if policy == "bf16-accum":
            return torch.sum(R * R).float()
        return torch.sum(R.float() ** 2)

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = loss(x)
            g, = torch.autograd.grad(v, x)
        return torch.cat([v.reshape(1), g.reshape(-1)])

    # on the card an evaluation (a few hundred small kernels, up to 20 an
    # update where the line search finds no lower loss) is one CUDA graph
    # replay
    evaluate = CudaGraphed(value_and_grad)
    u = torch.zeros((1, n, n), device=dev, requires_grad=True)
    opt = ZoomLBFGS([u])

    def closure():
        vg = evaluate(u.detach())
        u.grad = vg[1:].view_as(u)
        return vg[0]

    for _ in range(steps):
        opt.step(closure)
    return _rel_l2_exact(u.detach(), exact, bc, basis)


def solve_mms_adam(n, comp_dt, steps=6000, lr=3e-2, device="cuda"):
    """First-order counterpart of :func:`solve_mms` (Adam, float32 master
    params): how much residual precision a first-order optimizer needs,
    the regime of network-parametrized (IBN) training."""
    from ..train.krylov import CudaGraphed

    dev = torch.device(device)
    basis, exact, fg, bc = _mms_problem(n, dev)
    nu = torch.ones((1, n, n), device=dev)

    def loss(u):
        u = torch.where(bc > 0.5, torch.zeros_like(u), u).to(comp_dt)
        R = residual(u, nu.to(comp_dt), fg.to(comp_dt), basis, n, bc)
        return torch.sum(R.float() ** 2)

    u = torch.zeros((1, n, n), device=dev, requires_grad=True)
    opt = torch.optim.Adam([u], lr=lr, capturable=dev.type == "cuda")

    def step(_):
        opt.zero_grad(set_to_none=True)
        v = loss(u)
        v.backward()
        opt.step()
        return v.detach()

    # on the card the step (a few hundred small kernels) is launch-bound:
    # the first runs eagerly, every later one is a CUDA graph replay (its
    # input, u's shape, is not read)
    graphed = CudaGraphed(step)
    for _ in range(steps):
        graphed(u.detach())
    return _rel_l2_exact(u.detach(), exact, bc, basis)


def throughput(n, bs, dt, iters=10, device="cuda", route="library"):
    """Elements a second of the residual (`route`) on `bs` fields of
    `n`^2 nodes in type `dt`: `iters` calls timed after 3 (the host clock
    around a synchronised card)."""
    dev = torch.device(device)
    basis = _basis(n, dev)
    u, nu, f = (a.to(dt) for a in _fields(n, bs, dev))
    bc = torch.zeros((n, n), device=dev)
    bc[0, :] = 1.0
    fn = _route(route)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        for _ in range(3):
            fn(u, nu, f, basis, n, bc)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(u, nu, f, basis, n, bc)
        sync()
    dt_s = (time.perf_counter() - t0) / iters
    return bs * (n - 1) ** 2 / dt_s


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def throughput_section(dev, routes) -> tuple[list, dict]:
    """Section 3's lines and figures: elem/s of each route in float32 and
    bf16."""
    n = int(os.environ.get("DIFFNET_BENCH_SIZE", "512"))
    where = device_label(dev)
    lines = [
        "",
        f"## 3. Residual throughput at {n}^2 (bs 8, 10 iters) — measured "
        f"on {where}",
        "",
        "| route | dtype | elem/s |",
        "|---|---|---|",
    ]
    figures = {}
    for route in routes:
        for dt in (torch.float32, torch.bfloat16):
            tp = throughput(n, 8, dt, device=dev, route=route)
            figures[f"{route}_{_dtype_name(dt)}"] = tp
            lines.append(f"| {route} | {_dtype_name(dt)} | {tp:.3e} |")
            print(f"throughput {route} {_dtype_name(dt)}: {tp:.3e} elem/s "
                  f"({where})", flush=True)
    return lines, figures


def _write(path, lines):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("wrote", os.path.normpath(path))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--throughput-only", action="store_true",
                   help="section 3 alone (written in place of the "
                        "section 3 of --out, or as a new file)")
    p.add_argument("--out", default=os.path.join("runs", "precision",
                                                 "MIXED_PRECISION.md"))
    add_port_flags(p)
    args = p.parse_args(argv)
    dev = device_of(args, "precision_study")
    with _float32_accumulation():
        return _study(args, dev)


@contextlib.contextmanager
def _float32_accumulation():
    """For the study's duration a bf16 matmul on the card accumulates in
    float32, as XLA's ``preferred_element_type`` does in the JAX package,
    and a float32 one takes no TF32; the process's settings are restored
    after."""
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved


def _study(args, dev) -> dict:
    routes = ROUTES if args.fused_kernels else ROUTES[:1]
    out = {"out": args.out}

    if args.throughput_only:
        lines, out["throughput"] = throughput_section(dev, routes)
        head = []
        if os.path.exists(args.out):
            with open(args.out) as fh:
                head = [fh.read().split("\n## 3.")[0].rstrip("\n")]
        _write(args.out, head + lines)
        return out

    lines = [
        "# Mixed-precision policy study (measured)",
        "",
        "Produced by `python -m diffnet_tpu_torch.examples.precision_study`"
        f" on {device_label(dev)}.",
        "",
        "Library policy under test: fields in bf16, basis tables cast to the",
        "field dtype, every contraction accumulates in float32 (`core/fem.py`",
        "`torch.matmul` with bf16 reduced-precision reduction off).",
        *(["K1's route: `poisson_residual_fused`, bf16 loads, float32",
           "arithmetic, one rounding on the store."] if args.fused_kernels
          else []),
        "",
        "## 1. Residual accuracy (bf16 fields vs f32, random data)",
        "",
        "| grid | route | rel-L2 of assembled residual |",
        "|---|---|---|",
    ]
    out["accuracy"], out["seconds"] = {}, {}
    t0 = time.perf_counter()
    for n in (128, 512):
        for route in routes:
            e = accuracy_vs_f32(n, device=dev, route=route)
            out["accuracy"][f"{route}_{n}"] = e
            lines.append(f"| {n}^2 | {route} | {e:.2e} |")
            print(f"accuracy n={n} {route}: {e:.3e}", flush=True)

    out["seconds"]["1"] = time.perf_counter() - t0
    lines += [
        "",
        "## 2. End-to-end MMS solve (Poisson 64^2 resmin, LBFGS 300 steps, "
        "f32 master params)",
        "",
        "| policy | final rel-L2 vs exact |",
        "|---|---|",
    ]
    out["solve"] = {}
    t0 = time.perf_counter()
    for policy in ("f32", "bf16-residual", "bf16-accum"):
        e = solve_mms(64, policy, device=dev)
        out["solve"][policy] = e
        lines.append(f"| {policy} | {e:.2e} |")
        print(f"solve {policy}: {e:.3e}", flush=True)

    out["seconds"]["2"] = time.perf_counter() - t0
    lines += [
        "",
        "## 2b. Same solve under a FIRST-ORDER optimizer "
        "(Poisson 32^2, Adam 6k steps, f32 master params)",
        "",
        "| residual dtype | final rel-L2 vs exact |",
        "|---|---|",
    ]
    out["adam"] = {}
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16):
        e = solve_mms_adam(32, dt, device=dev)
        out["adam"][_dtype_name(dt)] = e
        lines.append(f"| {_dtype_name(dt)} | {e:.2e} |")
        print(f"adam {_dtype_name(dt)}: {e:.3e}", flush=True)

    out["seconds"]["2b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tlines, out["throughput"] = throughput_section(dev, routes)
    out["seconds"]["3"] = time.perf_counter() - t0
    _write(args.out, lines + tlines)
    return out


if __name__ == "__main__":
    main()
