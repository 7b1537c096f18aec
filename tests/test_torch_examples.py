"""The port's example CLIs (``diffnet_tpu_torch.examples``) on the CPU:
one case for each of tests/test_examples_smoke.py's, at the same argv plus
``--device cpu``, asserting the same artifacts. Four of those argvs are
also the parity cases of tests/test_torch_examples_parity*.py (stokes_mms
--solver gmres, ns_ldc --solver newton, more_physics helmholtz --solver
direct at 17^2, ldc_validation --re 1000 at 17^2), which run the port's
CLI once and assert its artifacts beside the JAX figures; they are not run
twice. multichip_scaling.py's counterpart is ``parallel.scaling`` under
``torchrun`` (8 CPU ranks, gloo)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffnet_tpu_torch.examples import (eikonal_airfoil, eikonal_parametric,
                                        eikonal_reconstruction, ibn_3d,
                                        klsum_uq, more_physics,
                                        ns_fpc_parametric, ns_fps, ns_ldc,
                                        poisson_3d, poisson_ibn_parametric,
                                        poisson_mms_2d, query_run,
                                        stokes_mms, sweep)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def run_cli(mod, argv):
    return mod.main([str(a) for a in argv] + ["--device", "cpu"])


def test_poisson_example_cli(tmp_path):
    out = run_cli(poisson_mms_2d, ["--domain-size", 16, "--max-epochs", 5,
                                   "--out-dir", tmp_path])
    runs = os.listdir(tmp_path / "poisson-mms-resmin" / "version_0")
    assert "metrics.csv" in runs and "u.vti" in runs
    assert "contours.png" in runs and "best.ckpt" in runs
    assert np.isfinite(out["rel_l2"]) and out["u"].shape == (16, 16)


SMOKE = [
    (poisson_3d, ["--domain-size", 9, "--max-epochs", 3], "poisson-3d",
     ["u3d.vti", "metrics.csv"]),
    (stokes_mms, ["--domain-size", 12, "--max-epochs", 3], "stokes-mms",
     ["uvp.png", "metrics.csv"]),
    (ns_ldc, ["--domain-size", 12, "--max-epochs", 3], "ns-ldc-re100",
     ["midline_cuts.csv", "fields.png"]),
    (eikonal_reconstruction, ["--domain-size", 16, "--max-epochs", 2],
     "eikonal2d", ["sdf.png", "metrics.csv"]),
    (eikonal_reconstruction, ["--domain-size", 16, "--solver", "gn"],
     "eikonal2d", ["sdf.png"]),
    (eikonal_reconstruction, ["--nsd", 3, "--domain-size", 9,
                              "--max-epochs", 2], "eikonal3d",
     ["surface.obj", "sdf.png"]),
    (poisson_ibn_parametric, ["-b", 4, "--n-samples", 8, "--max-epochs", 1,
                              "--domain-size", 16], "ibn-2d",
     ["sample.png", "best.ckpt"]),
    # 16^3: the fifth Down of the U-Net gets a one-voxel map (flax's
    # padding gives an empty one)
    (ibn_3d, ["--domain-size", 16, "--batch-size", 2, "--n-samples", 4,
              "--max-epochs", 1], "ibn-3d", ["u.vti", "object.obj"]),
    # 32x64: the MultiOutUNet encoder needs >= 32 per axis
    (ns_fpc_parametric, ["--max-epochs", 1, "--n-samples", 2,
                         "--batch-size", 2, "--width", 64, "--height", 32,
                         "--base-filters", 2], "ns-fpc-synthetic",
     ["fields.png", "best.ckpt"]),
    (eikonal_airfoil, ["--domain-size", 16, "--max-epochs", 2],
     "eikonal-airfoil-teardrop", ["sdf.png", "best.ckpt"]),
    (more_physics, ["allen-cahn", "--domain-size", 17, "--solver",
                    "direct"], "allen-cahn", []),
    (sweep, ["--physics", "klsum", "--param", "n_train", "--values", "4,8",
             "--domain-size", 16, "--max-epochs", 1, "--batch-size", 4],
     "sweep-klsum-n_train", ["sweep.csv", "stats.json", "sweep.png"]),
]
SMOKE_IDS = ["poisson_3d", "stokes_mms", "ns_ldc", "eikonal_2d",
             "eikonal_2d-gn", "eikonal_3d", "poisson_ibn_parametric",
             "ibn_3d", "ns_fpc_parametric", "eikonal_airfoil",
             "allen-cahn-direct", "sweep-klsum"]


@pytest.mark.parametrize("mod,argv,run,files", SMOKE, ids=SMOKE_IDS)
def test_example_cli_smoke(tmp_path, mod, argv, run, files):
    out = run_cli(mod, list(argv) + ["--out-dir", tmp_path])
    run_dir = tmp_path / run / "version_0"
    assert out["run_dir"] == str(run_dir)
    for name in files:
        assert (run_dir / name).exists(), name


def test_multichip_scaling_counterpart():
    """examples/multichip_scaling.py's argv (8 devices, data 4 x space 2)
    on parallel.scaling through torchrun: 8 gloo ranks on the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "diffnet_tpu_torch.parallel.scaling",
         "--data", "4", "--space", "2", "--domain-size", "16",
         "--batch-size", "4", "--steps", "2", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loss:" in proc.stdout


@pytest.mark.parametrize("physics", ["helmholtz", "advdiff", "allen-cahn",
                                     "burgers", "fsdt", "topopt"])
def test_more_physics_cli_smoke(tmp_path, physics):
    out = run_cli(more_physics, [physics, "--domain-size", 16,
                                 "--max-epochs", 2, "--out-dir", tmp_path])
    assert os.path.isdir(tmp_path / physics / "version_0")
    assert out["run_dir"] == str(tmp_path / physics / "version_0")


def test_klsum_uq_then_query_run_chain(tmp_path):
    """The train -> versioned-run-dir -> query pipeline (reference
    run-query.sh:20 + query.py:192-207 convention), through the kernels'
    plain versions (--fused-kernels on the CPU)."""
    out = run_cli(klsum_uq, ["--n-train", 8, "--n-query", 8,
                             "--batch-size", 4, "--max-epochs", 1,
                             "--domain-size", 16, "--out-dir", tmp_path,
                             "--fused-kernels"])
    run_dir = tmp_path / "klsum" / "version_0"
    assert (run_dir / "best.ckpt").exists()
    q = run_cli(query_run, [run_dir, "--domain-size", 16, "--n-query", 8,
                            "--batch-size", 4, "--fused-kernels"])
    assert (run_dir / "q_mean.npy").exists()
    assert (run_dir / "q_mean.vti").exists()
    assert np.isfinite(q["mean"]).all() and q["n_queried"] == 8
    # one epoch: best.ckpt holds the trained network
    for k, v in out["params"].items():
        assert torch.equal(q["params"][k], v), k


def test_ns_fps_stokes(tmp_path):
    """examples/run_all.sh's ns_fps argv (no smoke case in JAX's)."""
    out = run_cli(ns_fps, ["--eq", "stokes", "--re", 1, "--h", 1.0,
                           "--out-dir", tmp_path])
    run_dir = tmp_path / "fps-stokes-re1" / "version_0"
    assert (run_dir / "solution.npz").exists()
    assert np.isfinite(out["u"]).all()


def test_eikonal_parametric(tmp_path):
    """examples/run_all.sh's eikonal_parametric argv, cut to 5 epochs."""
    out = run_cli(eikonal_parametric, [
        "--net", "immdiff", "--n-train", 3, "--n-test", 1,
        "--domain-size", 32, "--n-points", 48, "--max-epochs", 5,
        "--out-dir", tmp_path])
    assert (tmp_path / "eik-param-immdiff" / "version_0"
            / "errors.txt").exists()
    assert all(np.isfinite(out["heldout_rel_l2"]))


def test_cuda_default_raises_without_a_card(tmp_path):
    """--device defaults to cuda, and there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        poisson_mms_2d.main(["--domain-size", "9", "--out-dir",
                             str(tmp_path)])


@pytest.mark.parametrize("mod,argv", [
    (stokes_mms, ["--domain-size", "9", "--max-epochs", "1"]),
    (poisson_mms_2d, ["--domain-size", "9", "--loss-type", "strong",
                      "--max-epochs", "1"]),
], ids=["stokes", "poisson-strong"])
def test_fused_kernels_refused_where_the_module_has_none(tmp_path, mod,
                                                         argv):
    """--fused-kernels sets the module's option: a configuration it does
    not fuse raises there, uncaught."""
    with pytest.raises(ValueError, match="fused_kernels"):
        run_cli(mod, argv + ["--out-dir", tmp_path, "--fused-kernels"])


def test_fused_kernels_refused_without_a_fused_module(tmp_path):
    with pytest.raises(SystemExit):
        run_cli(eikonal_airfoil, ["--domain-size", 9, "--out-dir", tmp_path,
                                  "--fused-kernels"])


@pytest.mark.parametrize("coarse,fine", [((9, 9), (17, 17)),
                                         ((5, 9, 9), (9, 17, 17)),
                                         ((9, 17), (17, 33))],
                         ids=["2d", "3d", "2d-rect"])
def test_restriction_is_the_prolongation_vjp(coarse, fine):
    """The multigrid restriction calls the interpolation's backward op
    directly (so a CUDA graph can capture it): bit-equal to the VJP of
    prolong_field, with leading axes too."""
    from diffnet_tpu_torch.train.continuation import prolong_field
    from diffnet_tpu_torch.train.linear import _restriction

    _, vjp = torch.func.vjp(lambda c: prolong_field(c, fine),
                            torch.zeros(coarse))
    R = _restriction(coarse, fine)
    r = torch.randn((2,) + fine, generator=torch.Generator().manual_seed(0))
    for i in range(2):
        assert torch.equal(R(r[i]), vjp(r[i])[0])
    assert torch.equal(R(r)[1], vjp(r[1])[0])


def test_cuda_graphs_are_the_plain_path_on_the_cpu(monkeypatch):
    """gmres graphs its Arnoldi steps on CUDA tensors only: on CPU tensors
    it builds no CudaGraphed (here one that would raise), and its iterates
    solve the system; a CudaGraphed operator runs ``fn`` as it is on a
    CPU tensor."""
    from diffnet_tpu_torch.train import gmres, krylov
    from diffnet_tpu_torch.train.krylov import CudaGraphed

    g = torch.Generator().manual_seed(1)
    A = torch.randn(12, 12, generator=g) + 6 * torch.eye(12)
    b = torch.randn(12, generator=g)

    def refuse(fn):
        raise AssertionError("a CUDA graph on CPU tensors")

    monkeypatch.setattr(krylov, "CudaGraphed", refuse)
    x, _ = gmres(lambda v: A @ v, b, restart=4, maxiter=5)
    want = torch.linalg.solve(A, b)
    assert float((x - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(CudaGraphed(lambda v: 2 * v)(b), 2 * b)


def test_data_files_only_through_flags(tmp_path):
    """The CLIs read no data file unless a flag names one: by default the
    airfoil is the analytic teardrop and the obstacles synthetic ellipses;
    --airfoil-file and --obstacle-image read the named files."""
    ctrl, kind = eikonal_airfoil.airfoil_control_polygon()
    assert kind == "teardrop" and ctrl.shape == (24, 2)
    t = np.linspace(0, 2 * np.pi, 60)
    np.savetxt(tmp_path / "e864.dat",
               np.stack([1 + np.cos(t), 0.1 * np.sin(t)], -1))
    ctrl, kind = eikonal_airfoil.airfoil_control_polygon(
        path=str(tmp_path / "e864.dat"))
    assert kind == "e864"
    np.testing.assert_allclose([ctrl[:, 0].min(), ctrl[:, 0].max()],
                               [0.2, 0.8], atol=1e-6)

    L = (4.0, 1.0)
    chis, kind = ns_fpc_parametric.load_obstacles(3, (8, 16), L)
    assert kind == "synthetic" and len(chis) == 3
    mask = np.zeros((16, 32), np.float32)
    mask[6:10, 8:14] = 1.0
    np.save(tmp_path / "mask.npy", mask)
    chis, kind = ns_fpc_parametric.load_obstacles(
        3, (8, 16), L, image=str(tmp_path / "mask.npy"))
    assert kind == "airfoil" and len(chis) == 3
    assert chis[0].shape == (8, 16) and chis[0].sum() > 0
