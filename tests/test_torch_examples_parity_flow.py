"""The port's flow example CLIs against the JAX package's on the same argv,
on the CPU, at the tolerances of ``tests/test_torch_examples_parity.py``
(whose helpers this file takes): the Stokes GMRES solve and the NS
lid-driven cavity by Newton, longest first."""

import numpy as np

from diffnet_tpu_torch.examples import ns_ldc, stokes_mms
from tests.test_torch_examples_parity import (FLOOR, ITERS_SLACK, close,
                                              field_close, figure, run_jax,
                                              run_port)


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


def test_stokes_gmres(tmp_path):
    argv = ["--domain-size", 17, "--solver", "gmres"]
    lines = run_jax("examples/stokes_mms.py",
                    argv + ["--out-dir", tmp_path / "jax"])
    (rel,), (dec,) = figure(lines, r"u rel_L2: (\S+)")
    out = run_port(stokes_mms, argv + ["--out-dir", tmp_path / "port"])
    close(out["u_rel_l2"], rel, dec, "u rel L2")
    assert (tmp_path / "port" / "stokes-mms/version_0/uvp.png").exists()
