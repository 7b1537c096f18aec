#!/usr/bin/env python3
"""The JAX package's figures that the PyTorch port's single-instance
physics check (chip_smoke.py's slice L) is held to.

Runs the JAX package on the CPU on each case of slice L, at the grid on
which CONVERGENCE.md (or the JAX package's own test) measured it:

  L1 Helmholtz: the k = 0.5 MMS at 65^2 (``RectangleHelmholtzManufactured``,
     ``DirectField`` from zeros, LBFGS x 10, 100 epochs, as
     scripts/convergence_study.py), and the indefinite k = 12 MMS at 65^2
     through ``module_linear_solve(method="gmres", tol=1e-10)``
     (tests/test_linear_solve.py's configuration) with 100 restart cycles
     where the test allows 2,000: tol 1e-10 is below float32's reach, so
     every cycle runs, and the error is settled by 100 (rel L2 3.20138e-5
     against 3.20127e-5 after 2,000; the port on a CPU);
  L2 SUPG advection-diffusion: the nu = 0.05 MMS (LBFGS, 200 epochs) at
     33^2 from zeros and at 65^2 from zeros and from three seeded starts
     of 1e-7, 1e-6 and 1e-5: at 65^2 the error sits on float32's floor
     (the residual's rounding hides the slow error modes, and LBFGS stops
     where the loss stops falling), so it spreads 6.4e-4 to 9.9e-4 over
     these rounding-level starts where 33^2 spreads 0.4%; and
     ``AdvDiff2dRectangle`` skew to the mesh at 64^2 (nu = 1e-4, 80 LBFGS
     epochs, tests/test_physics2d.py's settings): the field's min, max and
     centre value;
  L3 space-time: ``SpaceTimeHeat`` at 33^2 (150 epochs), ``AllenCahnIceMelt``
     at 33^2 by the A = 0 linear solve then ``newton_solve``
     (tests/test_linear_solve.py's homotopy) with 5 Newton steps of at most
     4 GMRES(25) cycles where the test allows 30 of 150: the first step
     already lands on float32's floor (|F| 1.73e-5 to 1.04e-5, then
     1e-9 relative a step; the MMS error 1.50e-4 whatever the budget; the
     port on a CPU), ``BurgersSpaceTime`` deg 2 at 33^2 (100 epochs; heat
     and Burgers give the same figures to the bit after 300);
  L4 strong forms: ``PoissonTwoDof2D`` MMS at 33^2 (100 epochs, rel L2 of
     u on the nodes), ``PoissonFDM2D`` MMS at 64^2 (150 epochs, the largest
     interior error, tests/test_poisson_train.py's metric);
  L5 eikonal: the teardrop airfoil at 64^2 (a 200-point NURBS cloud on
     tests/test_physics_misc.py's control polygon, sdf_weight 100,
     normals_weight 10, LBFGS 200 epochs from the signed start: mean |u|
     on the cloud and the sign structure), the circle through
     ``eikonal_gn_residual`` + ``gauss_newton_solve(newton_iters=40,
     cg_iters=100, lm=1e-4)`` at 64^2 and the sphere (2,000 points) at
     32^3 the same way (mean |u - sdf| where r < 0.45), ``EikonalFDM2D``
     for 50 LBFGS epochs at 64^2 on examples/eikonal_reconstruction.py's
     ellipse (the first and last epoch loss).

Rel L2 errors are the quadrature ones of ``calc_l2_err`` unless noted.
Prints one JSON line per case, then one with all of them and the seconds.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_physics.py [CASE ...]

(~2.5 minutes on 8 CPU cores; CASE: helmholtz, advdiff, spacetime,
strong_forms, eikonal, all by default.) The cases' sizes, solutions and
scorers are those of scripts/torch_port_reference_physics_cases.py, which
chip_smoke.py imports too.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_port_reference_physics_cases import (  # noqa: E402
    AC_GRID, AC_LINEAR, AC_NEWTON, ADV_A, ADV_EPOCHS, ADV_GRID,
    ADV_GRID_COARSE, ADV_NU, ADV_START_SCALES, AIRFOIL_EPOCHS,
    AIRFOIL_POINTS, BURGERS_EPOCHS, BURGERS_GRID, CIRCLE_POINTS,
    EIK_FDM_EPOCHS, EIK_FDM_POINTS, EIK_GRID, EIK_WEIGHTS, FDM_EPOCHS,
    FDM_GRID, FIGURES, GN, HEAT_EPOCHS, HEAT_GRID, HELM_EPOCHS, HELM_GRID,
    HELM_K12, HELM_K12_MAXITER, HELM_K12_TOL, LBFGS_ITERS, PI,
    SKEW_EPOCHS, SKEW_GRID, SKEW_NU, SPHERE_GRID, SPHERE_POINTS,
    TWODOF_EPOCHS, TWODOF_GRID, BurgersMMS, ac_exact, ac_forcing,
    ac_frame, ac_linforcing, advdiff_exact, advdiff_forcing,
    advdiff_start, airfoil_control_polygon, airfoil_figures,
    burgers_exact, burgers_forcing, cloud_of, heat_exact_forcing,
    sdf_error)


# -- the JAX cases ------------------------------------------------------------

def _lbfgs(m, epochs, loader=None):
    from diffnet_tpu.train import Trainer

    return Trainer(max_epochs=epochs, optimizer="lbfgs",
                   lbfgs_max_iter=LBFGS_ITERS).fit(m, loader)


def _rel(m, u):
    eL2, _, uex = m.calc_l2_err(u)
    return float(eL2 / uex)


def case_helmholtz() -> dict:
    from diffnet_tpu.data.single_instances import \
        RectangleHelmholtzManufactured
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import Helmholtz2D
    from diffnet_tpu.train.linear import module_linear_solve

    n = HELM_GRID
    ds = RectangleHelmholtzManufactured(domain_size=n)
    ds.n_samples = 1
    m = Helmholtz2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                    domain_size=n, batch_size=1, exact_solution=ds.exact)
    st = _lbfgs(m, HELM_EPOCHS)
    mms = _rel(m, m.network.apply(st.params)[0])

    k = HELM_K12
    ds = RectangleHelmholtzManufactured(domain_size=n, khh=k)
    ds.n_samples = 1
    m = Helmholtz2D(DirectField((n, n)), ds, domain_size=n, batch_size=1,
                    khh=k, exact_solution=ds.exact,
                    forcing=lambda x, y: (2 * PI**2 - k**2) * np.sin(
                        PI * x) * np.sin(PI * y))
    u, info = module_linear_solve(m, method="gmres", tol=HELM_K12_TOL,
                                  maxiter=HELM_K12_MAXITER)
    return {"helmholtz_mms_rel_l2": mms,
            "helmholtz_k12_rel_l2": _rel(m, u)}


def case_advdiff() -> dict:
    import jax.numpy as jnp

    from diffnet_tpu.data.single_instances import (AdvDiff2dRectangle,
                                                   RectangleManufactured)
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde.advection import AdvDiff2D

    def mms(n, start_scale):
        ds = RectangleManufactured(domain_size=n)
        ds.n_samples = 1
        m = AdvDiff2D(DirectField((n, n), init=advdiff_start(n, start_scale)),
                      ds, adv=ADV_A, diffusivity=ADV_NU, domain_size=n,
                      batch_size=1, forcing=advdiff_forcing,
                      exact_solution=advdiff_exact, bc1_value=0.0)
        st = _lbfgs(m, ADV_EPOCHS)
        return _rel(m, m.network.apply(st.params)[0])

    starts = [mms(ADV_GRID, eps) for eps in ADV_START_SCALES]
    coarse = mms(ADV_GRID_COARSE, 0.0)

    n = SKEW_GRID
    ds = AdvDiff2dRectangle(domain_size=n)
    ds.n_samples = 1
    m = AdvDiff2D(DirectField((n, n), init=np.zeros((n, n))), ds, adv=ADV_A,
                  diffusivity=SKEW_NU, domain_size=n, batch_size=1,
                  bc1_value=1.0)
    st = _lbfgs(m, SKEW_EPOCHS)
    u = np.asarray(m.apply_bcs(m.network.apply(st.params),
                               jnp.asarray(ds[0][0])[None]))[0]
    return {"advdiff_mms_rel_l2": starts[0], "advdiff_mms_rel_l2_starts":
            starts, "advdiff_mms_coarse_rel_l2": coarse,
            "skew_min": float(u.min()),
            "skew_max": float(u.max()),
            "skew_centre": float(u[n // 2, n // 2])}


def case_spacetime() -> dict:
    import jax.numpy as jnp

    from diffnet_tpu.data.single_instances import (
        AllenCahnIceMeltRectangle, SpaceTimeRectangleManufactured)
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import (AllenCahnIceMelt, BurgersSpaceTime,
                                 SpaceTimeHeat)
    from diffnet_tpu.train.linear import newton_solve, solve_linear

    n = HEAT_GRID
    ds = SpaceTimeRectangleManufactured(domain_size=n)
    ds.n_samples = 1
    exact, forcing = heat_exact_forcing(ds)
    m = SpaceTimeHeat(DirectField((n, n), init=np.zeros((n, n))), ds,
                      domain_size=n, batch_size=1, exact_solution=exact,
                      forcing=forcing, u0=ds.u0)
    st = _lbfgs(m, HEAT_EPOCHS)
    heat = _rel(m, m.apply_bcs(m.network.apply(st.params),
                               jnp.asarray(ds[0][0])[None])[0])

    n = AC_GRID
    ds = ac_frame(AllenCahnIceMeltRectangle(domain_size=n), n)
    jin = jnp.asarray(ds[0][0])[None]
    bc1, bc2 = jin[..., 1], jin[..., 2]
    m1 = AllenCahnIceMelt(None, ds, domain_size=n, batch_size=1, ac_A=0.0,
                          forcing=ac_linforcing, u0=ds.u0)
    u_lin, _ = solve_linear(
        lambda u: m1.residual(m1.apply_bcs(u[None], jin), bc1, bc2)[0],
        (n, n), **AC_LINEAR)
    m = AllenCahnIceMelt(None, ds, domain_size=n, batch_size=1,
                         forcing=ac_forcing, exact_solution=ac_exact,
                         u0=ds.u0)
    x, info = newton_solve(
        lambda u: m.residual(m.apply_bcs(u[None], jin), bc1, bc2)[0],
        u_lin, **AC_NEWTON)
    ac = _rel(m, m.apply_bcs(x[None], jin)[0])

    n = BURGERS_GRID
    ds = BurgersMMS(n)
    m = BurgersSpaceTime(DirectField((n, n), init=np.zeros((n, n))), ds,
                         domain_size=n, batch_size=1, forcing=burgers_forcing,
                         exact_solution=burgers_exact)
    st = _lbfgs(m, BURGERS_EPOCHS)
    burgers = _rel(m, m.apply_bcs(m.network.apply(st.params),
                                  jnp.asarray(ds[0][0])[None])[0])
    return {"heat_rel_l2": heat, "allencahn_rel_l2": ac,
            "allencahn_newton_iters": info["newton_iters"],
            "allencahn_residual_history": info["residual_history"],
            "burgers_rel_l2": burgers}


def case_strong_forms() -> dict:
    import jax.numpy as jnp

    from diffnet_tpu.data.single_instances import RectangleManufactured
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import PoissonFDM2D, PoissonTwoDof2D

    n = TWODOF_GRID
    ds = RectangleManufactured(domain_size=n)
    ds.n_samples = 1
    m = PoissonTwoDof2D(DirectField((n, n), init=np.zeros((n, n)),
                                    n_fields=3), ds, domain_size=n,
                        batch_size=1)
    st = _lbfgs(m, TWODOF_EPOCHS)
    batch = jnp.asarray(ds[0][0])[None]
    u = np.asarray(m.apply_bcs(m.network.apply(st.params, batch), batch)[0])
    ue = RectangleManufactured.exact(ds.xx, ds.yy)
    twodof = float(np.linalg.norm(u[0] - ue) / np.linalg.norm(ue))

    n = FDM_GRID
    ds = RectangleManufactured(domain_size=n)
    ds.n_samples = 1
    m = PoissonFDM2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                     domain_size=n, batch_size=1)
    st = _lbfgs(m, FDM_EPOCHS)
    u = np.asarray(m.network.apply(st.params)[0])
    fdm = float(np.abs(u - RectangleManufactured.exact(ds.xx, ds.yy))
                [1:-1, 1:-1].max())
    return {"twodof_rel_l2": twodof, "fdm_max_interior_err": fdm}


def case_eikonal() -> dict:
    import jax.numpy as jnp

    from diffnet_tpu.core.geometry import (occupancy_from_cloud,
                                           sample_ellipse_cloud,
                                           sample_sphere_cloud)
    from diffnet_tpu.data.geometry_datasets import nurbs_curve
    from diffnet_tpu.data.loader import InMemoryDataset, NumpyLoader
    from diffnet_tpu.models import DirectField
    from diffnet_tpu.pde import Eikonal2D, Eikonal3D, signed_occupancy_init
    from diffnet_tpu.pde.eikonal import EikonalFDM2D, eikonal_gn_residual
    from diffnet_tpu.train import Callback
    from diffnet_tpu.train.linear import gauss_newton_solve

    def jp(a):
        return jnp.asarray(a)[None]

    out = {}
    n = EIK_GRID
    pts, nrm, area = nurbs_curve(airfoil_control_polygon(),
                                 n_samples=AIRFOIL_POINTS)
    cloud = cloud_of(pts, nrm, area)
    ds = InMemoryDataset(cloud[None], np.zeros((1, n, n, 1), np.float32))
    chi = np.asarray(occupancy_from_cloud(jp(pts), jp(nrm), jp(area),
                                          (n, n)))[0]
    u0 = np.asarray(signed_occupancy_init(jp(pts), jp(nrm), jp(area),
                                          (n, n)))[0]
    m = Eikonal2D(DirectField((n, n), init=u0), ds, domain_size=n,
                  batch_size=1, **EIK_WEIGHTS)
    st = _lbfgs(m, AIRFOIL_EPOCHS, NumpyLoader(ds, batch_size=1))
    out["airfoil"] = airfoil_figures(np.asarray(m.network.apply(st.params)[0]),
                                     pts, chi)

    for name, nn_, cloud_fn, cls in (
            ("circle_gn", n, lambda: sample_ellipse_cloud(
                n_points=CIRCLE_POINTS, center=(0.5, 0.5),
                radii=(0.25, 0.25)), Eikonal2D),
            ("sphere_gn", SPHERE_GRID,
             lambda: sample_sphere_cloud(n_points=SPHERE_POINTS,
                                         radius=0.25), Eikonal3D)):
        pts, nrm, area = cloud_fn()
        shape = (nn_,) * (2 if cls is Eikonal2D else 3)
        m = cls(None, None, domain_size=nn_, batch_size=1, **EIK_WEIGHTS)
        u0 = np.asarray(signed_occupancy_init(jp(pts), jp(nrm), jp(area),
                                              shape))[0]
        x, info = gauss_newton_solve(
            eikonal_gn_residual(m, cloud_of(pts, nrm, area)[None]),
            jnp.asarray(u0), **GN)
        out[name] = {"sdf_err": sdf_error(np.asarray(x)),
                     "gn_iters": info["gn_iters"],
                     "final_loss": info["loss_history"][-1],
                     "start_sdf_err": sdf_error(u0)}

    pts, nrm, area = sample_ellipse_cloud(n_points=EIK_FDM_POINTS,
                                          center=(0.5, 0.5),
                                          radii=(0.28, 0.18))
    cloud = cloud_of(pts, nrm, area)
    ds = InMemoryDataset(cloud[None], np.zeros((1, n, n, 1), np.float32))
    u0 = np.asarray(signed_occupancy_init(jp(pts), jp(nrm), jp(area),
                                          (n, n)))[0]
    m = EikonalFDM2D(DirectField((n, n), init=u0), ds, domain_size=n,
                     batch_size=1, **EIK_WEIGHTS)

    class Losses(Callback):
        losses = []

        def on_epoch_end(self, trainer, module, state, epoch, metrics):
            self.losses.append(metrics["loss"])

    cb = Losses()
    from diffnet_tpu.train import Trainer

    Trainer(max_epochs=EIK_FDM_EPOCHS, optimizer="lbfgs",
            lbfgs_max_iter=LBFGS_ITERS, callbacks=[cb]).fit(
        m, NumpyLoader(ds, batch_size=1))
    out["eikonal_fdm"] = {"first_loss": cb.losses[0],
                          "last_loss": cb.losses[-1]}
    return out


cases = {"helmholtz": case_helmholtz, "advdiff": case_advdiff,
         "spacetime": case_spacetime, "strong_forms": case_strong_forms,
         "eikonal": case_eikonal}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    out = {}
    for fn in [cases[c] for c in (sys.argv[1:] or cases)]:
        t1 = time.perf_counter()
        got = fn()
        print(json.dumps({"case": fn.__name__,
                          "s": time.perf_counter() - t1, **got}), flush=True)
        out.update(got)
    if not sys.argv[1:]:
        assert set(out) == set(FIGURES), set(out) ^ set(FIGURES)
    print(json.dumps({"jax_slice_L": out,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
