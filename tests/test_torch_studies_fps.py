"""The port's flow-past-square validation (``diffnet_tpu_torch.examples.
fps_validation``) against scripts/fps_validation.py on the CPU, and
chip_smoke.py's slice R against the reference script's cases.

Tolerance: the Stokes channel at h = 1/2, u, v and p within 1e-4 of max
|u| of JAX's solution (slice R3's limit; 1.2e-6 apart on this CPU). Both
packages' solves stop after 10 of the 200 GMRES cycles that solve_case
asks for (the settings it passes are checked): the float32 iterate
stagnates by then (the port's after 10 and after 200 cycles lie 1.6e-6
of max |u| apart on this CPU), and the 200 took ~28 s in each package."""

import inspect
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_studies import (ROOT, jax_script,  # noqa: F401
                                      one_torch_thread)

FIELD = 1e-4


CYCLES = 10
SETTINGS = {"tol": 1e-7, "maxiter": 200, "restart": 20}   # the JAX script's


@pytest.fixture(scope="module")
def stokes_h2():
    """The Stokes L12 channel at h = 1/2 in both packages, the port's in a
    thread while JAX solves; each package's ``stokes_linear_solve`` runs
    CYCLES GMRES cycles and records the settings solve_case passed."""
    import diffnet_tpu.train.linear as jlin

    import diffnet_tpu_torch.train.linear as plin
    from diffnet_tpu_torch.examples import fps_validation

    jfv = jax_script("fps_validation")
    port, passed = {}, {}

    def capped(pkg, solve):
        def run(m, **kw):
            passed[pkg] = kw
            return solve(m, **{**kw, "maxiter": CYCLES})
        return run

    def run():
        port["out"] = fps_validation.solve_case("stokes", 1, 12.0, 5.0, 0.5,
                                                device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlin, "stokes_linear_solve",
                   capped("jax", jlin.stokes_linear_solve))
        mp.setattr(plin, "stokes_linear_solve",
                   capped("port", plin.stokes_linear_solve))
        t = threading.Thread(target=run)
        t.start()
        ref = jfv.solve_case("stokes", 1, 12.0, 5.0, 0.5)
        t.join()
    return [np.asarray(a) for a in ref[:3]], port["out"], passed


def test_fps_stokes_matches_jax(stokes_h2):
    ref, (u, v, p, nx, ny, info), passed = stokes_h2
    assert passed["jax"] == SETTINGS
    assert {k: x for k, x in passed["port"].items() if k != "device"} == \
        SETTINGS
    assert (nx, ny) == (25, 11) and u.shape == (11, 25)
    scale = np.abs(ref[0]).max()
    for name, got, want in zip("uvp", (u, v, p), ref):
        assert np.abs(got - want).max() <= FIELD * scale, name
    assert info["gmres_info"] == 0


def test_fps_main_without_anchors(stokes_h2, tmp_path, monkeypatch,
                                  capsys):
    """With no --ref-dir main reads no anchor: it prints the solved
    midline figures and says so; with --ref-dir naming a directory that
    holds no anchor it skips the case. --fused-kernels is refused (K6
    takes square grids only)."""
    from diffnet_tpu_torch.examples import fps_validation

    u, v, p, nx, ny, info = stokes_h2[1]
    calls = []

    def solved(*args, **kw):
        calls.append(args)
        return u, v, p, nx, ny, info

    monkeypatch.setattr(fps_validation, "solve_case", solved)
    out = fps_validation.main(["--cases", "stokes12", "--h", "0.5",
                               "--out", str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert calls == [("stokes", 1, 12.0, 5.0, 0.5, torch.device("cpu"))]
    assert "stokes12: 25x11" in text and "no anchors given" in text
    assert out["rows"] == [] and (tmp_path / "stokes12.png").exists()
    np.testing.assert_array_equal(out["solved"]["stokes12"]["uX"],
                                  u[ny // 2, :])
    out = fps_validation.main(["--cases", "ns10", "--out", str(tmp_path),
                               "--ref-dir", str(tmp_path), "--device",
                               "cpu"])
    assert "skip ns10: no anchor" in capsys.readouterr().out
    assert len(calls) == 1 and out["rows"] == []
    with pytest.raises(SystemExit):
        fps_validation.main(["--fused-kernels", "--device", "cpu"])


def test_chip_smoke_and_the_jax_reference_script_share_the_cases(
        stokes_h2):
    """chip_smoke.py's slice R and scripts/torch_port_reference_studies.py
    take their cases from scripts/torch_port_reference_studies_cases.py,
    JAX_R holds every figure that script prints, and the cases' midline
    cuts are the port's."""
    import importlib.util

    from diffnet_tpu_torch.examples import fps_validation

    saved = list(sys.path)
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
        import torch_port_reference_studies_cases as rc

        spec = importlib.util.spec_from_file_location(
            "torch_port_reference_studies",
            os.path.join(ROOT, "scripts", "torch_port_reference_studies.py"))
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
    finally:
        sys.path[:] = saved
    shared = [k for k in vars(rc) if not k.startswith("_")
              and k not in ("annotations", "math", "np", "FIGURES")]
    for mod in (cs, ref):
        used = [k for k in shared if hasattr(mod, k)]
        assert len(used) >= 8, (mod.__name__, used)
        for k in used:
            assert getattr(mod, k) is getattr(rc, k), (mod.__name__, k)
    assert set(cs.JAX_R) == set(rc.FIGURES)
    assert list(cs.JAX_R["r1_errs"]) == list(rc.R1_ROWS)
    # slice R2 runs the port's study at its defaults: the cases' sizes
    from diffnet_tpu_torch.examples import precision_study as ps

    for fn, key in ((ps.solve_mms, "R2_MMS_STEPS"),
                    (ps.solve_mms_adam, "R2_ADAM_STEPS")):
        steps = inspect.signature(fn).parameters["steps"].default
        assert steps == getattr(rc, key), key
    u, v, p = stokes_h2[1][:3]
    port = fps_validation.midline_cuts(u, v, p, 12.0, 5.0, 0.5)
    for k, c in rc.midline_cuts(u, v, p, 0.5).items():
        np.testing.assert_array_equal(c, port[k])
