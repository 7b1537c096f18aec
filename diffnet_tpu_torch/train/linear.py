"""Matrix-free linear solvers over assembled Galerkin residuals (port of
``diffnet_tpu/train/linear.py``, the scalar-field part).

For the linear formulations the residual ``R(u) = A u - b`` is affine in
the nodal field, so a solve is a Krylov iteration on the matrix-free
operator ``A u = R(u) - R(0)`` with ``b = -R(0)``; the module's Dirichlet
masking keeps the substituted rows at zero. :func:`multigrid_preconditioner`
builds a geometric-multigrid V-cycle for it, on the assembled stencil of
every level (``train.stencil``), and ``stencil_kernel="cuda"`` runs those
stencils through the K4 kernel.

The mixed Stokes / Navier-Stokes systems solve over ``{'u', 'v', 'p'}``
fields, stacked into one ``[3, ny, nx]`` tensor for the Krylov solvers
(which take any tensor shape): :func:`stokes_linear_solve` runs
block-preconditioned GMRES (:func:`stokes_block_preconditioner`) on the
PSPG Stokes system, :func:`ns_newton_solve` Jacobian-free Newton-Krylov
(:func:`newton_solve`, Jacobian actions by ``torch.func.jvp``) on the VMS
Navier-Stokes system, whose residual runs K6 with ``fused_kernels=True``.
:func:`gauss_newton_solve` minimises a least-squares residual (the eikonal
and strong-form Burgers systems) by matrix-free Gauss-Newton-CG, its J v
products by the double-VJP identity.

Everything of one solve lives on one ``device`` (the card, ``"cuda"``, by
default, as ``Trainer(device=)``; without CUDA the default raises): modules
are moved there, fields are made there.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from . import krylov
from .continuation import prolong_field
from ..parallel.mesh import (block_bounds, gather_block,
                             halo_exchange, halo_exchange_transpose,
                             local_block)
from .stencil import (SplitStencil, check_kernel, extract_verified,
                      stencil_diag, stencil_matvec)

__all__ = ["solve_linear", "module_linear_solve", "multigrid_preconditioner",
           "newton_solve", "ns_newton_solve", "gauss_newton_solve",
           "stokes_block_preconditioner", "stokes_linear_solve"]


def _as_field(x, device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x)


class _Stacked:
    """Mixed fields ``{name: [ny, nx]}`` as one ``[k, ny, nx]`` tensor, in
    the keys' order, and back."""

    def __init__(self, keys):
        self.keys = tuple(keys)

    def pack(self, fields: Mapping) -> torch.Tensor:
        return torch.stack([fields[k] for k in self.keys])

    def unpack(self, x: torch.Tensor) -> dict:
        return {k: x[i] for i, k in enumerate(self.keys)}

    def wrap(self, fn: Callable | None) -> Callable | None:
        """A map of field dicts as a map of stacked tensors."""
        if fn is None:
            return None
        return lambda x: self.pack(fn(self.unpack(x)))


@torch.no_grad()
def solve_linear(residual_fn: Callable, shape, method: str = "cg",
                 tol: float = 1e-8, maxiter: int | None = None,
                 M: Callable | None = None, x0=None,
                 restart: int | None = None,
                 assemble: str | None = None, stencil_width: int = 3,
                 stencil_kernel: str | None = None, device="cuda",
                 mesh=None):
    """Solve ``residual_fn(u) == 0`` for an affine ``residual_fn``.

    residual_fn: nodal field ``[*shape]`` on `device` -> residual of the
        same shape (Dirichlet rows masked to zero). `shape` may also be a
        template dict of equal-shaped arrays (a mixed system such as Stokes'
        ``{'u','v','p'}``): residual_fn, M and x0 then map dicts, and the
        solution is a dict.
    method: ``'cg'`` (SPD), ``'bicgstab'`` or ``'gmres'`` (nonsymmetric).
    M: optional preconditioner ``v -> M v``.
    assemble: ``'stencil'`` extracts the operator's stencil once and
        iterates with :func:`~.stencil.stencil_matvec` (pass
        ``stencil_width=2*deg+1`` for deg-d elements).
    stencil_kernel: with ``assemble='stencil'``, ``'cuda'`` applies the
        stencil through the K4 kernel (width 3, 2D).
    mesh: a process mesh whose 'space' axis splits the field's rows (the
        JAX package's spatially sharded fields): `shape` is then this
        rank's block (a mixed system's fields are blocks alike, stacked),
        ``residual_fn`` maps blocks to blocks (e.g. through
        :func:`~diffnet_tpu_torch.parallel.poisson_stiffness_spatial_fused`)
        and every rank calls ``solve_linear`` at once; the inner products
        and norms run over the whole field, for every method. With
        ``assemble='stencil'`` each rank extracts its rows of the stencil
        and iterates with the split apply
        (:class:`~.stencil.SplitStencil`, through K4 with
        ``stencil_kernel='cuda'``). Returns this rank's block of the
        solution.

    gmres on a card without a mesh replays each Arnoldi step's
    ``M(A(v))`` as one CUDA graph (:func:`krylov.gmres`), and so does the
    multigrid V-cycle (:func:`multigrid_preconditioner`): the residual and
    M must then read nothing back to the host (a read raises RuntimeError
    at the capture) and keep no Python state that each call should update
    (a replay repeats the captured kernels, not the Python code).

    Returns ``(u, info)`` as the Krylov solver does. Raises ValueError if
    the residual is not affine (one extra residual evaluation at a random
    field, to float tolerance).
    """
    check_kernel(stencil_kernel)
    device = resolve_device(device, "solve_linear")
    if isinstance(shape, Mapping):
        shapes = {tuple(a.shape) for a in shape.values()}
        if len(shapes) != 1:
            raise ValueError("a mixed system's fields must share one shape, "
                             f"got {sorted(shapes)}")
        if assemble is not None:
            raise ValueError("assemble='stencil' supports grid operators "
                             "only, not mixed systems")
        st = _Stacked(shape)
        x0 = None if x0 is None else st.pack(
            {k: _as_field(x0[k], device) for k in st.keys})
        x, info = solve_linear(st.wrap(residual_fn),
                               (len(st.keys),) + shapes.pop(), method, tol,
                               maxiter, st.wrap(M), x0, restart, None,
                               stencil_width, stencil_kernel, device, mesh)
        return st.unpack(x), info
    if not (isinstance(shape, (tuple, list))
            and all(isinstance(s, (int, np.integer)) for s in shape)):
        raise ValueError("shape must be a tuple of ints or a dict of "
                         f"equal-shaped fields, got {shape!r}")
    shape = tuple(int(s) for s in shape)
    zero = torch.zeros(shape, device=device)
    b = -residual_fn(zero)

    def A(u):
        return residual_fn(u) + b

    # affinity: A(2x) == 2 A(x) for an affine R with the same b
    probe = _as_field(np.random.default_rng(0).standard_normal(shape),
                      device)
    A2 = A(2.0 * probe)
    A1 = A(probe)

    norm = krylov._norm(mesh)
    lin = float(norm(A2 - 2.0 * A1) / (norm(A1) + 1e-30))
    if lin > 1e-3:
        raise ValueError(
            "residual_fn is not affine in the field (relative linearity "
            f"defect {lin:.2e}); use the training path or continuation "
            "for nonlinear formulations")

    if assemble == "stencil":
        C, defect = extract_verified(A, shape, width=stencil_width,
                                     probe=probe, want=A1, device=device,
                                     mesh=mesh)
        if defect > 1e-4:
            raise ValueError(
                f"operator is not a width-{stencil_width} stencil "
                f"(relative defect {defect:.2e}); pass stencil_width="
                "2*deg+1 or drop assemble='stencil'")
        if mesh is not None and mesh.space > 1:
            A = SplitStencil(C, mesh, stencil_width, len(shape),
                             stencil_kernel)
        else:
            def A(u, C=C):
                return stencil_matvec(C, u, width=stencil_width,
                                      kernel=stencil_kernel)
    elif assemble is not None:
        raise ValueError(f"unknown assemble mode {assemble!r}")
    elif stencil_kernel is not None:
        raise ValueError("stencil_kernel requires assemble='stencil'")

    if maxiter is None:
        # the whole field's size
        maxiter = 10 * int((zero.numel() * (mesh.space if mesh else 1))
                           ** 0.5)
    kwargs = {"tol": tol, "maxiter": maxiter, "M": M,
              "x0": None if x0 is None else _as_field(x0, device)}
    if mesh is not None:
        kwargs["mesh"] = mesh
    if restart is not None:
        if method != "gmres":
            raise ValueError("restart applies to gmres only")
        kwargs["restart"] = restart
    solver = {"cg": krylov.cg, "bicgstab": krylov.bicgstab,
              "gmres": krylov.gmres}[method]
    return solver(A, b, **kwargs)


def module_linear_solve(module, inputs_tensor=None, forcing_tensor=None,
                        method: str = "cg", tol: float = 1e-8,
                        maxiter: int | None = None, M=None,
                        assemble: str | None = None,
                        stencil_width: int | None = None,
                        stencil_kernel: str | None = None, device="cuda"):
    """Direct linear solve of a pde module's single-instance problem.

    The module must expose ``residual_for_field(u, inputs, forcing)``; it is
    moved to `device`. Returns the solved nodal field (numpy) with the
    module's Dirichlet values substituted, and the solver's info.
    """
    if getattr(module, "eq_type", None) == "stokes":
        # mixed systems route to the block-preconditioned solver, which has
        # its own method, preconditioner and assembly: explicitly passed
        # scalar-path knobs raise instead of being ignored
        if method != "cg" or M is not None or assemble is not None \
                or forcing_tensor is not None:
            raise ValueError(
                "Stokes modules route to stokes_linear_solve "
                "(block-preconditioned gmres over the mixed residual); "
                "method/M/assemble/forcing_tensor do not apply - call "
                "stokes_linear_solve directly to set its parameters")
        if tol < 1e-6:
            import warnings
            warnings.warn(
                f"Stokes route clamps tol {tol:g} -> 1e-6: the f32 "
                "preconditioned GMRES hits the float Arnoldi floor there; "
                "run stokes_linear_solve yourself to override", stacklevel=2)
            tol = 1e-6
        return stokes_linear_solve(module, inputs_tensor=inputs_tensor,
                                   maxiter=maxiter or 100, tol=tol,
                                   device=device)
    res_hook = getattr(module, "residual_for_field", None)
    if res_hook is None:
        raise ValueError(
            f"{type(module).__name__} does not expose residual_for_field; "
            "linear solves are wired for the Poisson family (Stokes routes "
            "to stokes_linear_solve; NS to ns_newton_solve)")
    device = resolve_device(device, "module_linear_solve")
    module.to(device)
    if inputs_tensor is None:
        if module.dataset is None:
            raise ValueError("no inputs given and module.dataset is None")
        inputs_tensor, forcing_tensor = module.dataset[0]
    inputs = _as_field(inputs_tensor, device)[None]
    forcing = (_as_field(forcing_tensor, device)[None]
               if forcing_tensor is not None else None)

    def residual_fn(u):
        return res_hook(u[None], inputs, forcing)[0]

    if stencil_width is None:
        # deg-d elements couple d+1 nodes per axis -> width 2d+1
        stencil_width = 2 * int(getattr(module, "fem_basis_deg", 1)) + 1
    u, info = solve_linear(residual_fn, module.node_shape, method=method,
                           tol=tol, maxiter=maxiter, M=M, assemble=assemble,
                           stencil_width=stencil_width,
                           stencil_kernel=stencil_kernel, device=device)
    apply_bcs = getattr(module, "apply_bcs", None)
    if apply_bcs is not None:
        with torch.no_grad():
            u = apply_bcs(u[None], inputs)[0]
    return u.cpu().numpy(), info


@torch.no_grad()
def _colored_diag(A: Callable, shape, nsd=None, device="cpu") -> np.ndarray:
    """Exact diagonal of a linear width-3 stencil operator from 3^nsd
    colouring probes (same-colour nodes, stride 3, do not interact; A is
    called once per probe). ``shape`` is an int (square/cubic, with
    ``nsd``) or a node-shape tuple. Returns numpy ``[shape]``."""
    if np.isscalar(shape):
        shape = (int(shape),) * int(nsd)
    shape = tuple(int(s) for s in shape)
    diag = np.zeros(shape, np.float32)
    for offs in np.ndindex(*((3,) * len(shape))):
        e = np.zeros(shape, np.float32)
        sl = tuple(slice(o, None, 3) for o in offs)
        e[sl] = 1.0
        diag[sl] = A(_as_field(e, device)).cpu().numpy()[sl]
    return diag


def _full_weight_halve(a, nsd):
    """Full-weighting restriction of a nodal field to the node-aligned half
    grid: [1/4, 1/2, 1/4] smoothing per axis (edge-replicated), then
    stride-2 injection. numpy, host-side (multigrid setup only)."""
    a = np.asarray(a, np.float64)
    for ax in range(a.ndim - nsd, a.ndim):
        p = np.concatenate([np.take(a, [0], ax), a, np.take(a, [-1], ax)],
                           axis=ax)
        n_ = a.shape[ax]
        a = (0.25 * np.take(p, range(0, n_), ax)
             + 0.5 * np.take(p, range(1, n_ + 1), ax)
             + 0.25 * np.take(p, range(2, n_ + 2), ax))
    sl = tuple([slice(None)] * (a.ndim - nsd)
               + [slice(None, None, 2)] * nsd)
    return a[sl].astype(np.float32)


def _restriction(coarse_shape, fine_shape) -> Callable:
    """The exact adjoint of ``prolong_field(., fine_shape)``: the backward
    op of its interpolation, the one its VJP runs, called directly (so it
    runs on the current stream, which a CUDA graph can capture, and not
    in the autograd engine's thread)."""
    coarse_shape = tuple(int(s) for s in coarse_shape)
    fine_shape = tuple(int(s) for s in fine_shape)
    nsd = len(fine_shape)
    op = (torch.ops.aten.upsample_bilinear2d_backward if nsd == 2
          else torch.ops.aten.upsample_trilinear3d_backward)
    scales = (None,) * nsd

    def R(r):
        lead = r.shape[:-nsd]
        g = r.reshape((-1, 1) + fine_shape)
        out = op(g, list(fine_shape), [g.shape[0], 1, *coarse_shape], True,
                 *scales)
        return out.reshape(lead + coarse_shape)
    return R


def _restricted_inputs(fine_inputs, fine_forcing, ns, nsd) -> dict:
    """Every level's (inputs, forcing), halved from the fine level's:
    continuous channels (nu) by full weighting, binary channels (masks) by
    injection so they stay {0, 1}."""
    fine_inputs = np.asarray(fine_inputs)
    levels = {ns[0]: (fine_inputs, None if fine_forcing is None
                      else np.asarray(fine_forcing))}
    is_binary = [bool(np.isin(np.unique(fine_inputs[..., c]),
                              (0.0, 1.0)).all())
                 for c in range(fine_inputs.shape[-1])]
    for li in range(1, len(ns)):
        prev_i, prev_f = levels[ns[li - 1]]
        chans = [prev_i[..., c][(slice(None, None, 2),) * nsd]
                 if is_binary[c] else _full_weight_halve(prev_i[..., c], nsd)
                 for c in range(prev_i.shape[-1])]
        cur_i = np.stack(chans, axis=-1).astype(prev_i.dtype)
        cur_f = (None if prev_f is None else np.stack(
            [_full_weight_halve(prev_f[..., c], nsd)
             for c in range(prev_f.shape[-1])], axis=-1).astype(prev_f.dtype))
        levels[ns[li]] = (cur_i, cur_f)
    return levels


@torch.no_grad()
def multigrid_preconditioner(module_factory, n_fine, n_coarse: int = 9,
                             n_smooth: int = 3, inputs_per_level=None,
                             nsd: int = 2, coarse_op: str = "rediscretize",
                             assemble: str | None = "stencil",
                             smoother: str = "chebyshev",
                             cheb_alpha: float = 4.0,
                             fine_matvec: Callable | None = None,
                             stencil_kernel: str | None = None,
                             device="cuda", mesh=None):
    """Geometric-multigrid V-cycle preconditioner ``M ~ A^-1`` for
    :func:`solve_linear` on node-aligned grid hierarchies (n = 2^k + 1).

    n_fine: an int (square/cubic; ``module_factory`` is called with
        per-level ints) or a node-shape tuple (rectangular; the factory is
        called with per-level shape tuples, ``n_coarse`` bounds the
        smallest axis).
    module_factory(n) -> a module exposing ``residual_for_field``; it is
        moved to `device`, where the whole hierarchy lives.
    inputs_per_level: ``"restrict"`` halves the fine module's (inputs,
        forcing) to every level (full weighting for nu, injection for
        masks), a callable ``n -> (inputs, forcing)``, or None (each
        level's own dataset).
    coarse_op: ``"rediscretize"`` (each level's module) or ``"galerkin"``
        (``A_l = R A_{l-1} P`` through the level above).
    assemble: ``"stencil"`` extracts every level's stencil once,
        ``"stencil_coarse"`` all but the finest, None none; a level whose
        probe defect rejects the stencil form keeps its matrix-free
        operator.
    smoother: ``"chebyshev"`` (degree ``n_smooth`` in D^-1 A on
        [lmax/cheb_alpha, lmax], lmax from a setup power iteration, padded
        1.1x) or ``"jacobi"`` (damped, omega = 0.8/lmax).
    fine_matvec: a linear fine-grid operator used at run time in place of
        the factory module's (which still drives all setup probing; the two
        must agree to round-off), e.g. a module with ``fused_kernels=True``.
    stencil_kernel: ``"cuda"`` applies every assembled level's run-time
        stencil (not the finest when `fine_matvec` is given, not the
        coarsest, which runs the dense pseudo-inverse) through K4.

    mesh: a process mesh whose 'space' axis splits the rows (2D; planes in
        3D): ``M`` then maps this rank's block of the fine level
        (:func:`~diffnet_tpu_torch.parallel.local_block`) to its block of
        ``M v``, every rank calling at once, and `fine_matvec` maps blocks
        to blocks (e.g. through
        :func:`~diffnet_tpu_torch.parallel.poisson_stiffness_spatial_fused`).
        The setup (stencils, diagonals, the power iterations, the coarse
        pseudo-inverse) runs on the whole hierarchy on every rank, from the
        factory's whole-field modules: the same numbers as without a mesh.
        The V-cycle runs split on every level whose blocks
        (:func:`~diffnet_tpu_torch.parallel.block_bounds`) hold at least 2
        rows and fall at row a where the level above's fall at row 2a: its
        stencil through :class:`~.stencil.SplitStencil` (K4 with
        `stencil_kernel`), its smoother and inverse diagonal on the block,
        the prolongation with one coarse halo row and the restriction, its
        adjoint, with the exchange's transpose. Below, the level is
        gathered onto every rank (``gather_block``), the rest of the cycle
        runs whole there, and each rank keeps its rows on the way up. The
        same linear map as without a mesh, to rounding. Every split level
        but a `fine_matvec` one must be assembled (``assemble='stencil'``).

    The prolongation is ``train.continuation.prolong_field``, the
    restriction its exact adjoint, the coarsest level a dense
    pseudo-inverse (``rcond=1e-5``, numpy on the host) built by probing,
    applied as a matmul. On a card without a mesh ``M`` is one CUDA graph
    of the whole V-cycle (``krylov.CudaGraphed``: the first call runs and
    captures it, later ones replay it), one launch from the host for its
    hundreds of small kernels: a `fine_matvec` must then read nothing back
    to the host (a read raises RuntimeError at the capture). Returns
    ``(M, info)``.
    """
    if smoother not in ("chebyshev", "jacobi"):
        raise ValueError(f"unknown smoother {smoother!r} "
                         "(expected 'chebyshev' or 'jacobi')")
    if assemble not in ("stencil", "stencil_coarse", None):
        raise ValueError(f"unknown assemble mode {assemble!r} (expected "
                         "'stencil', 'stencil_coarse', or None)")
    check_kernel(stencil_kernel)
    device = resolve_device(device, "multigrid_preconditioner")
    split_mesh = mesh is not None and mesh.space > 1
    if stencil_kernel is not None and assemble is None:
        raise ValueError("stencil_kernel requires an assembling mode "
                         "('stencil' or 'stencil_coarse')")
    if smoother == "chebyshev" and not cheb_alpha > 1.0:
        raise ValueError(
            f"cheb_alpha must be > 1 (got {cheb_alpha}): the smoothing "
            "band is [lmax/cheb_alpha, lmax], and alpha <= 1 collapses "
            "it (delta <= 0 -> NaN recurrence)")

    # the hierarchy: every axis halves together down to n_coarse
    rect = not np.isscalar(n_fine)
    if rect:
        shapes = [tuple(int(s) for s in n_fine)]
        nsd = len(shapes[0])
    else:
        shapes = [(int(n_fine),) * nsd]
    while min(shapes[-1]) > n_coarse:
        if any((s - 1) % 2 for s in shapes[-1]):
            break
        nxt = tuple((s - 1) // 2 + 1 for s in shapes[-1])
        if min(nxt) < 3:
            break
        shapes.append(nxt)
    ns = shapes if rect else [s[0] for s in shapes]

    if inputs_per_level == "restrict":
        m_fine = module_factory(n_fine)
        if m_fine.dataset is None:
            raise ValueError("inputs_per_level='restrict' needs the fine "
                             "module to own a dataset")
        levels = _restricted_inputs(*m_fine.dataset[0], ns, nsd)
        inputs_per_level = levels.__getitem__

    ops, omegas, invdiags, lams = [], [], [], []
    kernel_swaps = []   # (level, C) to route through K4 after setup
    for li, n in enumerate(ns):
        shape = shapes[li]
        if coarse_op == "galerkin" and li > 0:
            fine_shape = shapes[li - 1]

            def A(u, A_prev=ops[-1], fs=fine_shape,
                  R=_restriction(shape, fine_shape)):
                return R(A_prev(prolong_field(u, fs)))
        else:
            m = module_factory(n).to(device)
            if inputs_per_level is not None:
                inputs, forcing = inputs_per_level(n)
            else:
                inputs, forcing = m.dataset[0]
            inputs = _as_field(inputs, device)[None]
            forcing = (_as_field(forcing, device)[None]
                       if forcing is not None else None)

            def res(u, m=m, inputs=inputs, forcing=forcing):
                return m.residual_for_field(u[None], inputs, forcing)[0]

            def A(u, res=res, b0=res(torch.zeros(shape, device=device))):
                return res(u) - b0
        if assemble == "stencil" or (assemble == "stencil_coarse" and li > 0):
            C, defect = extract_verified(A, shape, device=device)
            if defect <= 1e-4:
                def A(u, C=C):
                    return stencil_matvec(C, u)
                kernel_swaps.append((li, C))
                diag = stencil_diag(C).cpu().numpy()
            else:
                diag = _colored_diag(A, shape, device=device)
        else:
            diag = _colored_diag(A, shape, device=device)
        # Dirichlet rows have a zero diagonal; their smoothed update must
        # stay zero, so park a 1.0 there
        safe = np.abs(diag) > 1e-12
        invdiag = _as_field(np.where(safe, 1.0 / np.where(safe, diag, 1.0),
                                     1.0), device)

        def DinvA(u, A=A, invdiag=invdiag):
            return invdiag * A(u)

        # power iteration for the top of D^-1 A's spectrum (20 steps)
        v = _as_field(np.random.default_rng(0).random(shape), device)
        for _ in range(20):
            v = DinvA(v)
            v = v / (_norm(v) + 1e-30)
        lam = float(torch.vdot(v.reshape(-1), DinvA(v).reshape(-1))
                    / (torch.vdot(v.reshape(-1), v.reshape(-1)) + 1e-30))
        if li == 0 and fine_matvec is not None and not split_mesh:
            A = fine_matvec   # after all setup probing (a block map over
            #                   a mesh: the split cycle takes it)
        ops.append(A)
        invdiags.append(invdiag)
        omegas.append(0.8 / max(lam, 1e-30))
        # Chebyshev needs an upper bound on lam(D^-1 A); power iteration
        # converges from below
        lams.append(1.1 * max(lam, 1e-30))

    # coarsest: dense pseudo-inverse by probing (Dirichlet rows are zero
    # rows, which pinv keeps at zero); rcond cuts the f32-noise modes the
    # R(u) - R(0) cancellation leaves in the masked rows
    nc_shape = shapes[-1]
    ndof = int(np.prod(nc_shape))
    cols = np.empty((ndof, ndof), np.float32)
    for i in range(ndof):
        e = torch.zeros(ndof, device=device)
        e[i] = 1.0
        cols[i] = ops[-1](e.reshape(nc_shape)).reshape(-1).cpu().numpy()
    A0_pinv = _as_field(np.linalg.pinv(cols.T, rcond=1e-5), device)

    if stencil_kernel is not None:
        for li, C in kernel_swaps:
            if li == 0 and fine_matvec is not None:
                continue   # the explicit run-time fine operator wins
            if li == len(ns) - 1:
                continue   # the coarsest level runs the dense pinv only

            def op(u, C=C):
                return stencil_matvec(C, u, kernel=stencil_kernel)
            ops[li] = op

    restricts = [_restriction(shapes[li + 1], shapes[li])
                 for li in range(len(ns) - 1)]

    def smooth(level, u, b, k):
        A, invdiag = ops[level], invdiags[level]
        if smoother == "jacobi":
            omega = omegas[level]
            for _ in range(k):
                u = u + omega * invdiag * (b - A(u))
            return u
        # degree-k Chebyshev in D^-1 A on [lmax/cheb_alpha, lmax] (three-
        # term recurrence, r updated incrementally: r_new = r - A d); the
        # coefficients are fixed floats, so the smoother is linear in b
        lmax = lams[level]
        lmin = lmax / cheb_alpha
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        r = b - A(u)
        d = invdiag * r / theta
        u = u + d
        rho_prev = 1.0 / sigma
        for _ in range(k - 1):
            r = r - A(d)
            rho = 1.0 / (2.0 * sigma - rho_prev)
            d = (rho * rho_prev) * d + (2.0 * rho / delta) * (invdiag * r)
            u = u + d
            rho_prev = rho
        return u

    restrict = [lambda r, R=R: R(r) for R in restricts]
    prolong = [lambda e_c, fs=shapes[li]: prolong_field(e_c, fs)
               for li in range(len(ns) - 1)]
    split_levels = 0
    if split_mesh:
        cyc = _SplitCycle(mesh, shapes, nsd, fine_matvec,
                          dict(kernel_swaps), invdiags, stencil_kernel,
                          device)
        split_levels = cyc.levels
        if not split_levels:
            raise ValueError(f"multigrid over a mesh: the fine level "
                             f"{shapes[0]} does not split into blocks of at "
                             f"least 2 rows over {mesh.space} ranks")
        for li in range(cyc.levels):
            ops[li], invdiags[li] = cyc.ops[li], cyc.invdiags[li]
            if li + 1 < cyc.levels:
                restrict[li] = partial(cyc.restrict, li=li)
                prolong[li] = partial(cyc.prolong, li=li)
            else:   # the next level runs whole on every rank
                restrict[li] = (lambda r, R=restricts[li], n=shapes[li][0]:
                                R(gather_block(r, mesh, 0, "space", n=n)))
                prolong[li] = partial(cyc.prolong_gather, li=li)

    def vcycle(level, b):
        if level == len(ns) - 1:
            return (A0_pinv @ b.reshape(-1)).reshape(b.shape)
        u = smooth(level, torch.zeros_like(b), b, n_smooth)
        r = b - ops[level](u)
        e_c = vcycle(level + 1, restrict[level](r))
        u = u + prolong[level](e_c)
        return smooth(level, u, b, n_smooth)

    @torch.no_grad()
    def M(v):
        return vcycle(0, v)

    if not split_mesh and torch.device(device).type == "cuda":
        M = krylov.CudaGraphed(M)
    return M, {"levels": ns, "omegas": omegas, "smoother": smoother,
               "split_levels": split_levels}


class _SplitCycle:
    """The split levels of a multigrid hierarchy over a mesh's 'space' axis
    (see :func:`multigrid_preconditioner`): levels ``0 .. levels - 1`` run
    on row blocks, the rest gathered. Built from the whole-field setup:
    each split level's stencil C and inverse diagonal are cut to this
    rank's block."""

    def __init__(self, mesh, shapes, nsd, fine_matvec, C_by_level,
                 invdiags, stencil_kernel, device):
        self.mesh, self.shapes, self.nsd = mesh, shapes, nsd
        k = mesh.space
        # split while every block holds >= 2 rows and the level's splits
        # fall at half the level above's (the coarsest is always whole)
        bounds = []
        for li, shape in enumerate(shapes[:-1]):
            try:
                b = block_bounds(shape[0], k)
            except ValueError:
                break
            if min(b1 - b0 for b0, b1 in zip(b, b[1:])) < 2:
                break
            if li and b[1:-1] != [x // 2 for x in bounds[-1][1:-1]] \
                    or li and any(x % 2 for x in bounds[-1][1:-1]):
                break
            bounds.append(b)
        self.levels = len(bounds)
        self.bounds = bounds
        self.ops, self.invdiags, self._restrict_local = [], [], []
        j = mesh.space_index
        self.first = 1 if mesh.space_neighbour(-1) is not None else 0
        self.last = 1 if mesh.space_neighbour(1) is not None else 0
        for li in range(self.levels):
            if li == 0 and fine_matvec is not None:
                self.ops.append(fine_matvec)
            elif li in C_by_level:
                Cl = local_block(C_by_level[li], mesh, 1, "space")
                self.ops.append(SplitStencil(Cl, mesh, 3, nsd,
                                             stencil_kernel))
            else:
                raise ValueError(
                    f"multigrid over a mesh: level {li} ({shapes[li]}) has "
                    "no assembled stencil to split; pass assemble='stencil' "
                    "(and fine_matvec for a matrix-free fine level)")
            self.invdiags.append(local_block(invdiags[li], mesh, 0, "space"))
            if li + 1 < self.levels:
                # the coarse rows a prolongation reads: this block's and the
                # next block's first (none after the last block)
                nc = bounds[li + 1][j + 1] - bounds[li + 1][j] + self.last
                cshape = (nc,) + tuple(shapes[li + 1][1:])
                fshape = (2 * nc - 1,) + tuple(shapes[li][1:])
                self._restrict_local.append(
                    _restriction(cshape, fshape))
            else:
                self._restrict_local.append(None)

    def _fine_rows(self, li):
        j = self.mesh.space_index
        return self.bounds[li][j + 1] - self.bounds[li][j]

    def prolong(self, e_c, li):
        """Level li + 1's block -> level li's block: the coarse block grown
        by the next block's first row, prolongated, cut to this block."""
        ext = halo_exchange(e_c, self.mesh, 1, 0, zero_edges=False)
        ext = ext.narrow(0, self.first, ext.shape[0] - self.first)
        fine = prolong_field(ext, (2 * ext.shape[0] - 1,)
                             + tuple(self.shapes[li][1:]))
        return fine.narrow(0, 0, self._fine_rows(li))

    def restrict(self, r, li):
        """The adjoint of :meth:`prolong`: level li's block -> level li +
        1's block."""
        pad = list(r.shape)
        pad[0] = self.last
        rf = torch.cat([r, r.new_zeros(pad)]) if self.last else r
        c = self._restrict_local[li](rf)
        if self.first:
            pad = list(c.shape)
            pad[0] = 1
            c = torch.cat([c.new_zeros(pad), c])
        return halo_exchange_transpose(c, self.mesh, 1, 0, zero_edges=False)

    def prolong_gather(self, e_c, li):
        """The last split level's block from the whole next level."""
        return local_block(prolong_field(e_c, self.shapes[li]), self.mesh, 0,
                           "space")


class _FieldDataset:
    """One sample of prescribed (nu, bc1[, bc2]) channels: the glue that
    builds Poisson multigrid hierarchies over a mixed system's blocks."""

    def __init__(self, nu, bc1, bc2=None):
        if bc2 is None:
            bc2 = np.zeros_like(nu)
        self.inputs = np.stack([nu, bc1, bc2], -1).astype(np.float32)
        self.forcing = np.zeros(nu.shape + (1,), np.float32)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


class _ReactionShifted(nn.Module):
    """Screened Poisson for multigrid hierarchies: the inner Poisson
    module's residual plus ``sigma * M u`` (the consistent Galerkin mass,
    Dirichlet rows and columns masked, so the shift is a symmetric PSD
    perturbation), rediscretised on every level."""

    def __init__(self, inner, sigma):
        super().__init__()
        self.inner = inner
        self.sigma = float(sigma)

    @property
    def dataset(self):
        return self.inner.dataset

    def residual_for_field(self, u, inputs_tensor, forcing_tensor):
        from ..pde.poisson import _squeeze_field

        inner = self.inner
        R = inner.residual_for_field(u, inputs_tensor, forcing_tensor)
        mask = torch.maximum(inputs_tensor[..., 1], inputs_tensor[..., 2])
        uu = torch.where(mask > 0.5, 0.0, _squeeze_field(u))
        gpN = inner.gp_all(uu, ("N",))["N"]
        Mu = inner.assemble_multi([(gpN, "N")])
        return R + self.sigma * torch.where(mask > 0.5, 0.0, Mu)


def stokes_block_preconditioner(module, inputs_tensor=None, n_coarse=9,
                                n_smooth=3, momentum_reaction=0.0,
                                device="cuda"):
    """Block-diagonal preconditioner ``M = diag(MG_visc, MG_visc,
    S_hat^-1)`` for a flow module's mixed ``{'u','v','p'}`` residual:

    * momentum blocks: the geometric-multigrid V-cycle
      (:func:`multigrid_preconditioner`) on the viscous Laplacian
      ``visco * K`` with that field's Dirichlet mask (one V-cycle serves
      both when the u and v masks coincide);
    * pressure block: the inverse diagonal of the PSPG Schur surrogate
      ``S_hat = pspg * K_p + M_p / visco``, both diagonals probed exactly by
      3^2 colouring.

    ``momentum_reaction = sigma > 0`` shifts the momentum hierarchy to the
    screened Laplacian ``visco K + sigma M`` (the pseudo-transient surrogate
    of an NS Jacobian's advection block at ``sigma ~ |u| / h``). Returns
    ``M`` mapping a residual dict to a dict; the module is moved to
    `device`. For Stokes the preconditioned operator is nonsymmetric: use
    GMRES.
    """
    from ..core import fem
    from ..pde.poisson import Poisson2D

    if getattr(module, "eq_type", None) not in ("stokes", "ns"):
        raise ValueError("stokes_block_preconditioner expects a mixed-"
                         "system flow module (eq_type 'stokes' or 'ns')")
    device = resolve_device(device, "stokes_block_preconditioner")
    module.to(device)
    if inputs_tensor is None:
        inputs_tensor, _ = module.dataset[0]
    inputs = (inputs_tensor.cpu().numpy()
              if isinstance(inputs_tensor, torch.Tensor)
              else np.asarray(inputs_tensor))
    node_shape = tuple(module.node_shape)
    lengths = (module.domain_lengthX, module.domain_lengthY)
    visco = module.viscosity

    def momentum_mg(mask):
        ds_fine = _FieldDataset(np.full(node_shape, visco, np.float32), mask)

        def factory(m_shape):
            if np.isscalar(m_shape):
                m_shape = (int(m_shape),) * 2
            ny_l, nx_l = m_shape
            m_p = Poisson2D(None, ds_fine if tuple(m_shape) == node_shape
                            else None, domain_sizes=(nx_l, ny_l),
                            domain_lengths=lengths, batch_size=1,
                            loss_type="resmin")
            if momentum_reaction:
                return _ReactionShifted(m_p, momentum_reaction)
            return m_p

        M, _ = multigrid_preconditioner(
            factory, node_shape, n_coarse=n_coarse, n_smooth=n_smooth,
            inputs_per_level="restrict", device=device)
        return M

    bc_u, bc_v = inputs[..., 2], inputs[..., 3]
    M_u = momentum_mg(bc_u)
    M_v = M_u if np.array_equal(bc_u, bc_v) else momentum_mg(bc_v)

    # the pressure block: no bc_p masking, since the solver paths replace
    # the pin by the mean control (pde/flow.py mixed_residual)
    basis = module.basis

    def KP(p):
        gp = fem.gp_eval(p, basis, ("dx", "dy"))
        return fem.galerkin_project_multi(
            [(gp["dx"], "dx"), (gp["dy"], "dy")], basis, node_shape)

    def MP(p):
        gp = fem.gp_eval(p, basis, ("N",))["N"]
        return fem.galerkin_project(gp, basis, "N", node_shape)

    s_diag = (module.pspg_param * _colored_diag(KP, node_shape, device=device)
              + _colored_diag(MP, node_shape, device=device) / visco)
    safe = np.abs(s_diag) > 1e-12
    inv_s = _as_field(np.where(safe, 1.0 / np.where(safe, s_diag, 1.0), 1.0),
                      device)

    @torch.no_grad()
    def M(r):
        return {"u": M_u(r["u"]), "v": M_v(r["v"]), "p": inv_s * r["p"]}

    return M


def stokes_linear_solve(module, inputs_tensor=None, tol=1e-6, maxiter=100,
                        restart=10, n_coarse=9, n_smooth=3, device="cuda"):
    """Block-preconditioned GMRES on a PSPG Stokes module's mixed residual,
    then the pinned pressure gauge restored by a constant shift (the
    mean-controlled solve leaves p mean-free). Returns ``((u, v, p)`` numpy
    nodal fields with Dirichlet data substituted, ``info)``."""
    device = resolve_device(device, "stokes_linear_solve")
    module.to(device)
    if inputs_tensor is None:
        inputs_tensor, _ = module.dataset[0]
    inputs = _as_field(inputs_tensor, device)[None]

    def resfn(fields):
        R = module.residual_for_field({k: v[None] for k, v in fields.items()},
                                      inputs, None)
        return {k: v[0] for k, v in R.items()}

    M = stokes_block_preconditioner(module, inputs_tensor=inputs_tensor,
                                    n_coarse=n_coarse, n_smooth=n_smooth,
                                    device=device)
    tmpl = {k: torch.zeros(module.node_shape) for k in ("u", "v", "p")}
    sol, info = solve_linear(resfn, tmpl, method="gmres", tol=tol,
                             maxiter=maxiter, M=M, restart=restart,
                             device=device)
    return _substitute_and_restore_gauge(module, inputs_tensor, inputs,
                                         sol), info


@torch.no_grad()
def _substitute_and_restore_gauge(module, inputs_tensor, inputs, sol):
    """The mixed solvers' tail: substitute the Dirichlet data, then restore
    the pinned pressure gauge by a constant shift of the non-pin nodes (a
    constant is null for every other equation of the masked system)."""
    u, v, p = (t[0].cpu().numpy() for t in module.apply_bcs(
        (sol["u"][None], sol["v"][None], sol["p"][None]), inputs))
    if getattr(module, "pressure_gauge", "mean-control") == "dirichlet":
        return (u, v, p)   # real p rows: apply_bcs substituted them
    bc3 = inputs[0, ..., 4].cpu().numpy() > 0.5
    if bc3.any():
        p_bc = np.broadcast_to(module.p_bc.cpu().numpy(), p.shape)
        sol_p = sol["p"].cpu().numpy()
        offset = float((p_bc[bc3] - sol_p[bc3]).mean())
        p = np.where(bc3, p, p + offset)
    return (u, v, p)


@torch.no_grad()
def newton_solve(residual_fn, x0, M=None, newton_iters=20, tol=1e-6,
                 gmres_iters=40, restart=10, lm0=0.0, verbose=False,
                 device="cuda"):
    """Jacobian-free Newton-Krylov: solve ``residual_fn(x) == 0`` for a
    nonlinear residual of a tensor, or of a dict of equal-shaped tensors
    (then M maps dicts too, and x comes back as a dict).

    The Jacobian action is one ``torch.func.jvp`` through the residual (no
    Jacobian is formed), each direction preconditioned GMRES
    (``restart``-step cycles, at most ``gmres_iters`` of them, tol 1e-4),
    each step globalised by a backtracking line search on |F| (8 halvings,
    sufficient decrease 1e-4). ``lm0 > 0`` adds Levenberg damping
    ``(J + lam I) dx = -F``, lam x0.3 after a full step and x10 (at least
    lm0) after a failed search, stopping above 1e4. On a card each
    direction's Arnoldi steps replay ``M(J v)`` as one CUDA graph
    (:func:`krylov.gmres`): the residual and M must read nothing back to
    the host (a read raises RuntimeError at the capture), and the Python
    code in them runs at each direction's capture, not at each step (a
    counter of residual calls inside them counts captures).

    Returns ``(x, info)``: ``info['residual_history']`` (|F| per outer
    iteration, ending at the returned iterate) and ``info['newton_iters']``
    (accepted steps).
    """
    device = resolve_device(device, "newton_solve")
    if isinstance(x0, Mapping):
        st = _Stacked(x0)
        x, info = newton_solve(st.wrap(residual_fn),
                               st.pack({k: _as_field(x0[k], device)
                                        for k in st.keys}),
                               st.wrap(M), newton_iters, tol, gmres_iters,
                               restart, lm0, verbose, device)
        return st.unpack(x), info

    def newton_dir(x, Fx, lam):
        def Jv(v):
            return torch.func.jvp(residual_fn, (x,), (v,))[1] + lam * v

        dx, _ = krylov.gmres(Jv, -Fx, M=M, tol=1e-4, maxiter=gmres_iters,
                             restart=restart)
        return dx

    x = _as_field(x0, device)
    hist = []
    Fx = residual_fn(x)
    n0 = float(_norm(Fx))
    newton_done = 0
    lam = float(lm0)
    for it in range(newton_iters):
        hist.append(n0)
        if verbose:
            print(f"newton {it}: |F| = {n0:.3e} lam = {lam:.1e}")
        if n0 < tol:
            break
        dx = newton_dir(x, Fx, lam)
        alpha = 1.0
        accepted = False
        for _ in range(8):
            x_try = x + alpha * dx
            F_try = residual_fn(x_try)
            n_try = float(_norm(F_try))
            if n_try < (1.0 - 1e-4 * alpha) * n0:
                x, Fx, n0 = x_try, F_try, n_try
                newton_done += 1
                accepted = True
                break
            alpha *= 0.5
        if accepted:
            if lm0 and alpha == 1.0:
                lam *= 0.3   # a trustworthy model: anneal toward Newton
        elif lm0:
            lam = max(lam * 10.0, float(lm0))
            if lam > 1e4:
                break        # damping saturated: return the best iterate
        else:
            break            # undamped and no descent direction
    else:
        hist.append(n0)      # budget spent: |F| of the returned iterate
    return x, {"residual_history": hist, "newton_iters": newton_done}


def ns_newton_solve(module, inputs_tensor=None, newton_iters=20, tol=1e-6,
                    gmres_iters=40, restart=10, n_coarse=9, n_smooth=3,
                    x0=None, lm0=0.0, momentum_reaction=0.0, verbose=False,
                    device="cuda"):
    """Newton-Krylov solve of the full-VMS Navier-Stokes mixed system
    (the module's ``mixed_residual``; K6 with ``fused_kernels=True``),
    preconditioned by :func:`stokes_block_preconditioner`, from `x0` (a
    ``{'u','v','p'}`` dict; rest by default).

    ``momentum_reaction="auto"`` shifts the momentum multigrid by
    ``sigma = max |u_bc|, |v_bc| / h`` (needed near Re 1000, with
    ``lm0=1e-3``); a number sets sigma; 0 keeps the viscous multigrid.
    On a card each GMRES step's preconditioned Jacobian action is one CUDA
    graph replay (:func:`newton_solve`): the host launches its ~10^3
    kernels once a Newton direction, not once a step.
    Returns ``((u, v, p)`` numpy nodal fields with Dirichlet data and the
    pressure gauge restored, ``info)`` as :func:`newton_solve`.
    """
    device = resolve_device(device, "ns_newton_solve")
    module.to(device)
    if inputs_tensor is None:
        inputs_tensor, _ = module.dataset[0]
    inputs = _as_field(inputs_tensor, device)[None]

    def F(fields):
        R = module.mixed_residual({k: v[None] for k, v in fields.items()},
                                  inputs, None)
        return {k: v[0] for k, v in R.items()}

    if momentum_reaction == "auto":
        # sigma = |u|/h caps the preconditioned advection spectrum at O(1);
        # |u| from the Dirichlet data (the velocity scale of a driven flow)
        u_scale = max(float(module.u_bc.abs().max()),
                      float(module.v_bc.abs().max()), 1e-30)
        momentum_reaction = u_scale / module.h
    M = stokes_block_preconditioner(module, inputs_tensor=inputs_tensor,
                                    n_coarse=n_coarse, n_smooth=n_smooth,
                                    momentum_reaction=momentum_reaction,
                                    device=device)
    if x0 is None:
        x0 = {k: torch.zeros(module.node_shape) for k in ("u", "v", "p")}
    x, info = newton_solve(F, x0, M=M, newton_iters=newton_iters, tol=tol,
                           gmres_iters=gmres_iters, restart=restart, lm0=lm0,
                           verbose=verbose, device=device)
    return _substitute_and_restore_gauge(module, inputs_tensor, inputs,
                                         x), info


def _leaves(r) -> list:
    """The tensors of a residual, a tensor or a dict of tensors (in sorted
    key order, as ``jax.tree.leaves`` orders a dict)."""
    if isinstance(r, torch.Tensor):
        return [r]
    return [r[k] for k in sorted(r)]


def _normal_equations(residual_fn, x: torch.Tensor):
    """``(J^T r, v -> J^T J v)`` of `residual_fn` at `x`, J its Jacobian.

    J^T is a reverse-mode product; J v is the double-VJP identity ``J v =
    d/dw <J^T w, v>``: J^T w is built once, with its graph, as a function
    of a zero cotangent w, and each J v is one backward pass through that
    graph (on the eikonal residual, on a CPU, a fifth of the time of
    ``torch.func.jvp``, with the same values). The residual must be twice
    differentiable in reverse mode."""
    xr = x.detach().requires_grad_()
    with torch.enable_grad():
        leaves = _leaves(residual_fn(xr))
        ws = [torch.zeros_like(y, requires_grad=True) for y in leaves]
        jtw, = torch.autograd.grad(leaves, xr, ws, create_graph=True)
    g, = torch.autograd.grad(leaves, xr, [y.detach() for y in leaves],
                             retain_graph=True)

    def JTJ(v):
        jv = torch.autograd.grad(jtw, ws, v, retain_graph=True)
        return torch.autograd.grad(leaves, xr, jv, retain_graph=True)[0]

    return g, JTJ


@torch.no_grad()
def gauss_newton_solve(residual_fn, x0, newton_iters=25, tol=1e-10,
                       cg_iters=50, lm=0.0, verbose=False, device="cuda"):
    """Matrix-free Gauss-Newton: minimise ``||r(x)||^2`` for a residual
    ``r(x)`` of a field ``x``, a tensor or a dict of tensors of any
    shapes. x keeps the dtype of a floating tensor `x0` (numpy arrays
    become float32).

    Each direction solves ``(J^T J + lm I) dx = -J^T r`` by CG (tol 1e-6,
    at most ``cg_iters`` iterations) on the products of
    :func:`_normal_equations` (no matrix formed); each step is globalised
    by a backtracking line search on ``||r||^2`` (10 halvings, sufficient
    decrease 1e-4). Stops below `tol`, after `newton_iters` directions, or
    when a search fails.

    Returns ``(x, info)``: ``info['loss_history']`` (``||r||^2`` at the
    start and after each accepted step) and ``info['gn_iters']`` (accepted
    steps).
    """
    device = resolve_device(device, "gauss_newton_solve")

    def phi(x):
        return sum(torch.sum(y * y) for y in _leaves(residual_fn(x)))

    def gn_dir(x):
        g, JTJ = _normal_equations(residual_fn, x)
        A = (lambda v: JTJ(v) + lm * v) if lm else JTJ
        dx, _ = krylov.cg(A, -g, tol=1e-6, maxiter=cg_iters)
        return dx

    x = (x0.to(device) if isinstance(x0, torch.Tensor)
         and x0.is_floating_point() else _as_field(x0, device))
    p0 = float(phi(x))
    hist = [p0]
    accepted = 0
    for it in range(newton_iters):
        if verbose:
            print(f"gauss-newton {it}: ||r||^2 = {p0:.3e}")
        if p0 < tol:
            break
        dx = gn_dir(x)
        alpha = 1.0
        for _ in range(10):
            x_try = x + alpha * dx
            p_try = float(phi(x_try))
            if p_try < (1.0 - 1e-4 * alpha) * p0:
                x, p0 = x_try, p_try
                accepted += 1
                hist.append(p0)
                break
            alpha *= 0.5
        else:
            break
    return x, {"loss_history": hist, "gn_iters": accepted}
