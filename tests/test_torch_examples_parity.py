"""The port's example CLIs against the JAX package's on the same argv, for
the deterministic solves, on the CPU. The JAX figure is parsed from the
JAX CLI's printed output (its last line, or the solver line before it);
the port's headline figure must lie within 1e-3 relative of it (plus half
a unit in the last digit the JAX CLI prints), or within 1.3x of it where
float32's floor sets the figure; where the JAX CLI writes the field (u.vti,
midline_cuts.csv), the port's field lies within 1e-4 of max |u| of it;
the port takes at most JAX's Newton or Gauss-Newton iterations + 2. Each
case also asserts the port's run-dir artifacts (four of these argvs are
tests/test_examples_smoke.py's, see tests/test_torch_examples.py). Also:
ibn_3d --data-devices 2 on two gloo ranks against one process, and the
U-Nets at 16 nodes a side (a one-node map reaches the fifth Down)
against flax."""

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from diffnet_tpu_torch.examples import (eikonal_reconstruction, ibn_3d,
                                        ldc_validation, more_physics,
                                        ns_ldc, poisson_mms_2d, stokes_mms)

ROOT = os.path.join(os.path.dirname(__file__), "..")
REL = 1e-3          # headline figures, relative
FLOOR = 1.3         # figures set by float32's floor: at most 1.3x JAX's
FIELD = 1e-4        # fields, times max |u| of JAX's
ITERS_SLACK = 2     # Newton / Gauss-Newton iterations: JAX's + 2


def run_jax(script, argv):
    """Run a JAX CLI (examples/ or scripts/) in-process; its stdout lines."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(script)[:-3], os.path.join(ROOT, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old, buf = sys.argv, io.StringIO()
    sys.argv = ["x"] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = old
    return buf.getvalue().strip().splitlines()


def run_port(mod, argv):
    return mod.main([str(a) for a in argv] + ["--device", "cpu"])


def figure(lines, pattern):
    """The last match of `pattern` in the JAX CLI's lines: its groups as
    floats, and the number of decimals each was printed with."""
    m = [re.search(pattern, ln) for ln in lines]
    m = next(x for x in reversed(m) if x)
    return [float(g) for g in m.groups()], [
        len(g.split(".")[1].split("e")[0]) if "." in g else 0
        for g in m.groups()]


def close(port, ref, decimals, what):
    """Within REL relative of JAX's printed figure, plus half a unit in its
    last printed digit (``%.3e`` prints 3 decimals of the mantissa)."""
    mant = abs(ref) / 10 ** np.floor(np.log10(abs(ref))) if ref else 1.0
    unit = 0.5 * 10.0 ** -decimals * (abs(ref) / mant if mant else 1.0)
    assert abs(port - ref) <= REL * abs(ref) + unit, (what, port, ref)


def read_vti(path):
    """The ASCII point data of a 2D VTI file as [ny, nx]."""
    with open(path) as f:
        text = f.read()
    ext = [int(v) for v in re.search(r'WholeExtent="([^"]+)"',
                                     text).group(1).split()]
    body = re.search(r"<DataArray[^>]*>(.*?)</DataArray>", text, re.S)
    vals = np.array(body.group(1).split(), dtype=np.float64)
    return vals.reshape(ext[3] - ext[2] + 1, ext[1] - ext[0] + 1)


def field_close(port, ref, what):
    tol = FIELD * np.abs(ref).max()
    assert np.abs(np.asarray(port) - ref).max() <= tol, what


def test_poisson_cg(tmp_path):
    argv = ["--domain-size", 17, "--optimizer", "cg"]
    lines = run_jax("examples/poisson_mms_2d.py",
                    argv + ["--out-dir", tmp_path / "jax"])
    (rel,), (dec,) = figure(lines, r"rel_L2: (\S+)")
    out = run_port(poisson_mms_2d, argv + ["--out-dir", tmp_path / "port"])
    close(out["rel_l2"], rel, 3, "rel L2")
    run = "poisson-mms-resmin/version_0"
    field_close(out["u"], read_vti(tmp_path / "jax" / run / "u.vti"), "u")
    assert (tmp_path / "port" / run / "contours.png").exists()


def _reference_cli():
    """scripts/torch_port_reference_cli.py, for its ``_k1`` switch."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference_cli",
        os.path.join(ROOT, "scripts", "torch_port_reference_cli.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", [False, True], ids=["unfused", "k1"])
def test_poisson_mg_cg(tmp_path, kernel):
    """The MG-CG solve at 65^2, as the JAX CLI runs it (the unfused
    residual) and with the stiffness kernel in both packages (the JAX CLI
    through scripts/torch_port_reference_cli.py's switch, its Pallas
    kernel interpreted; the port's CLI with --fused-kernels). At 513^2 the
    two forms' figures part (the unfused residual's float32 rounding sets
    JAX's 4.1e-4; the kernel's form reaches the discretisation error,
    3.2e-6, in both packages); here each pair agrees."""
    argv = ["--domain-size", 65, "--optimizer", "mg-cg"]
    switch = (_reference_cli()._k1() if kernel
              else contextlib.nullcontext())
    with switch:
        lines = run_jax("examples/poisson_mms_2d.py",
                        argv + ["--out-dir", tmp_path / "jax"])
    (rel,), (dec,) = figure(lines, r"rel_L2: (\S+)")
    out = run_port(poisson_mms_2d, argv + ["--out-dir", tmp_path / "port"]
                   + (["--fused-kernels"] if kernel else []))
    close(out["rel_l2"], rel, dec, "rel L2")
    run = "poisson-mms-resmin/version_0"
    field_close(out["u"], read_vti(tmp_path / "jax" / run / "u.vti"), "u")
    assert out["solve_s"] is not None


def test_stokes_gmres(tmp_path):
    argv = ["--domain-size", 17, "--solver", "gmres"]
    lines = run_jax("examples/stokes_mms.py",
                    argv + ["--out-dir", tmp_path / "jax"])
    (rel,), (dec,) = figure(lines, r"u rel_L2: (\S+)")
    out = run_port(stokes_mms, argv + ["--out-dir", tmp_path / "port"])
    close(out["u_rel_l2"], rel, dec, "u rel L2")
    assert (tmp_path / "port" / "stokes-mms/version_0/uvp.png").exists()


def test_ns_ldc_newton(tmp_path):
    argv = ["--domain-size", 17, "--solver", "newton"]
    lines = run_jax("examples/ns_ldc.py",
                    argv + ["--out-dir", tmp_path / "jax"])
    (iters, F), _ = figure(lines, r"newton iters: (\d+)\s+\|F\|: (\S+)")
    out = run_port(ns_ldc, argv + ["--out-dir", tmp_path / "port"])
    assert out["newton_iters"] <= iters + ITERS_SLACK
    # |F| after the last step sits on float32's floor
    assert out["final_F"] <= FLOOR * F, (out["final_F"], F)
    run = "ns-ldc-re100/version_0/midline_cuts.csv"
    ref = np.loadtxt(tmp_path / "jax" / run, delimiter=",", skiprows=1)
    got = np.loadtxt(tmp_path / "port" / run, delimiter=",", skiprows=1)
    for col, name in ((1, "u"), (2, "v"), (3, "p")):
        field_close(got[:, col], ref[:, col], name)


def test_helmholtz_direct(tmp_path):
    argv = ["helmholtz", "--domain-size", 17, "--solver", "direct"]
    lines = run_jax("examples/more_physics.py",
                    argv + ["--out-dir", tmp_path / "jax"])
    (rel,), (dec,) = figure(lines, r"helmholtz rel_L2: (\S+)")
    out = run_port(more_physics, argv + ["--out-dir", tmp_path / "port"])
    close(out["rel_l2"], rel, dec, "rel L2")
    assert (tmp_path / "port" / "helmholtz" / "version_0").is_dir()


def test_eikonal_gauss_newton(tmp_path):
    argv = ["--domain-size", 16, "--solver", "gn"]
    lines = run_jax("examples/eikonal_reconstruction.py",
                    argv + ["--out-dir", tmp_path / "jax"])
    (iters, loss), (_, dec) = figure(
        lines, r"gauss-newton iters: (\d+)\s+loss: (\S+)")
    out = run_port(eikonal_reconstruction,
                   argv + ["--out-dir", tmp_path / "port"])
    assert out["gn_iters"] <= iters + ITERS_SLACK
    close(out["final_loss"], loss, dec, "final loss")
    assert (tmp_path / "port" / "eikonal2d/version_0/sdf.png").exists()


def test_ldc_validation_re1000(tmp_path):
    """The Ghia Re-1000 check at 17^2 (the one level, 17 <= 49). The port
    runs it with --fused-kernels: on the CPU that is K6's plain version
    with its written-out tangent, where torch.func.jvp through the plain
    residual runs forward-mode AD operation by operation at about twice
    the time."""
    argv = ["--re", 1000, "--solver", "newton", "--domain-size", 17]
    lines = run_jax("scripts/ldc_validation.py",
                    argv + ["--out", tmp_path / "jax.png"])
    (n, iters, F), _ = figure(
        lines, r"n=(\d+): newton iters=(\d+) \|F\|=(\S+)")
    (eu, ev), decs = figure(
        lines, r"Ghia u-midline max err (\S+), v-midline max err (\S+)")
    out = run_port(ldc_validation, argv + ["--out", tmp_path / "port.png",
                                           "--fused-kernels"])
    assert (tmp_path / "port.png").exists()
    (level,) = out["levels"]
    assert level["n"] == n and level["newton_iters"] <= iters + ITERS_SLACK
    assert level["final_F"] < 1e-6
    close(out["ghia_err_u"], eu, decs[0], "Ghia u error")
    close(out["ghia_err_v"], ev, decs[1], "Ghia v error")


def test_ibn_3d_data_parallel(tmp_path):
    """--data-devices 2: two gloo ranks, each on its row of every batch of
    2, against one process on the whole batches."""
    argv = ["--domain-size", 16, "--batch-size", 2, "--n-samples", 4,
            "--max-epochs", 1]
    one = run_port(ibn_3d, argv + ["--out-dir", tmp_path / "one"])
    two = run_port(ibn_3d, argv + ["--data-devices", 2,
                                   "--out-dir", tmp_path / "two"])
    assert two["world"] == 2
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    for k, v in one["params"].items():
        # Adam's first steps move an entry by ~lr whatever its gradient's
        # size: a rounding-level gradient may swing one
        diff = np.abs(two["params"][k] - v)
        assert float((diff > 1e-5).mean()) <= 1e-3, k
    assert (tmp_path / "two" / "ibn-3d/version_0/u.vti").exists()


@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 3), (1, 16, 32, 3)],
                         ids=["unet3d-16", "unet-16x32"])
def test_unet_one_node_bottleneck(shape):
    """At 16 nodes a side the fifth Down takes a one-node map: flax's (1, 1)
    padding makes it empty and the first Up's transposed conv gives zeros;
    the port's U-Nets give the same outputs (ibn_3d's smoke argv)."""
    from diffnet_tpu import models as jm
    from diffnet_tpu_torch import models as tm
    from diffnet_tpu_torch.interop import params_from_jax

    ndim = len(shape) - 2
    jnet = (jm.UNet3D if ndim == 3 else jm.UNet)(out_channels=1,
                                                 base_filters=2)
    tnet = (tm.UNet3D if ndim == 3 else tm.UNet)(3, 1, base_filters=2)
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    params = jnet.init(jax.random.key(1), x)
    tnet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(params, x)),
                               atol=1e-5)
