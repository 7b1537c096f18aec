"""The port's convergence study (``diffnet_tpu_torch.examples.
convergence_study``) against scripts/convergence_study.py on the CPU: the
2D Poisson solvers (deg 1 to 3, resmin and energy, the deg-1 rows also
through the fused kernels' plain versions) at their smallest --quick
grids with a few LBFGS epochs, the per-h rate formula,
the --fused-kernels refusal, the table written under ``runs/``, and the
three study modules' imports (no JAX, no JAX package, no scripts/).

Tolerance: each relative L2 error within 5e-3 relative of JAX's (after 3
epochs of 10 iterations these solves sit at their discretisation error;
the two LBFGS implementations part by up to 2.5e-3 there)."""

import ast
import functools
import importlib.util
import math
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REL = 5e-3
EPOCHS = 3


@functools.lru_cache(maxsize=None)
def jax_script(name):
    """scripts/<name>.py, imported by path (it pins JAX to the CPU), once
    a process: the study files a test worker runs share one module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    argv, sys.argv = sys.argv, ["x"]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's small CPU solves on one intra-op thread: with the
    machine's cores shared by the test workers, bf16 matmuls on 8 threads
    ran ~40x slower (0.5 s against 20 s for a 17^2 bf16 LBFGS solve)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcs():
    return jax_script("convergence_study")


@pytest.fixture(scope="module")
def pcs():
    from diffnet_tpu_torch.examples import convergence_study

    return convergence_study


# (name, JAX call, the port's keyword arguments beyond the device)
POISSON = [
    ("resmin-deg1", (17, 1, "resmin"), {}),
    ("resmin-deg1-fused", (17, 1, "resmin"), {"fused_kernels": True}),
    ("energy-deg1", (17, 1, "energy"), {}),
    ("energy-deg1-fused", (17, 1, "energy"), {"fused_kernels": True}),
    ("resmin-deg2", (9, 2, "resmin"), {}),
    ("resmin-deg3", (7, 3, "resmin"), {}),
]


@pytest.fixture(scope="module")
def jax_poisson(jcs):
    return {args: jcs.solve_poisson(*args, epochs=EPOCHS)
            for args in dict.fromkeys(a for _, a, _ in POISSON)}


@pytest.mark.parametrize("name,args,kw", POISSON,
                         ids=[p[0] for p in POISSON])
def test_solve_poisson_matches_jax(pcs, jax_poisson, name, args, kw):
    """solve_poisson at the row's smallest quick grid; the fused variants
    run K1's (resmin) and K3's (energy) plain versions on the CPU and are
    held to JAX's unfused solve."""
    got = pcs.solve_poisson(*args, epochs=EPOCHS, device="cpu", **kw)
    ref = jax_poisson[args]
    assert abs(got - ref) <= REL * ref, (name, got, ref)


def test_rate_formula():
    """rates_of is rate_row's per-h formula (and the reference cases'
    copy): CONVERGENCE.md's deg-1 resmin errors give its 2.00 / 2.06, and
    a non-halving refinement (17, 33, 49) uses the h ratio, not log2."""
    from diffnet_tpu_torch.examples.convergence_study import rates_of

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from torch_port_reference_studies_cases import rates
    finally:
        sys.path.pop(0)
    grids, errs = [17, 33, 65], [3.21e-3, 8.02e-4, 1.92e-4]
    got = rates_of(grids, errs)
    assert ["%.2f" % r for r in got] == ["2.00", "2.06"]
    assert got == rates(grids, errs)
    grids, errs = [17, 33, 49], [5.69e-3, 1.47e-3, 6.24e-4]
    want = [math.log(errs[0] / errs[1]) / math.log(32 / 16),
            math.log(errs[1] / errs[2]) / math.log(48 / 32)]
    assert rates_of(grids, errs) == want
    assert ["%.2f" % r for r in want] == ["1.95", "2.11"]


def test_rows_are_the_jax_scripts(pcs):
    """The 11 rows of the JAX script's main, with its grids and expected
    rates; the kernel of each fused row."""
    src = open(os.path.join(ROOT, "scripts", "convergence_study.py")).read()
    for key, (name, quick, full, expect, kernel, _) in pcs.ROWS.items():
        assert f'"{name}"' in src, name
        assert f'"{expect}"' in src, expect
    assert len(pcs.ROWS) == 11
    assert {k: v[4] for k, v in pcs.ROWS.items() if v[4]} == {
        "poisson-resmin-deg1": "K1", "poisson-energy-deg1": "K3",
        "poisson3d": "K5"}
    assert pcs.ROWS["stokes"][1:3] == ([17, 33], [17, 33, 49])
    assert pcs.ROWS["poisson-resmin-deg3"][1:3] == ([7, 13], [7, 13, 25])


def test_fused_flag_refused_for_plain_rows(pcs, tmp_path):
    for rows in ([], ["--rows", "poisson-resmin-deg2"],
                 ["--rows", "poisson-resmin-deg1", "helmholtz"]):
        with pytest.raises(SystemExit):
            pcs.main(["--quick", *rows, "--fused-kernels", "--device", "cpu",
                      "--out", str(tmp_path / "x.md")])


def test_default_out_under_runs(pcs, tmp_path, monkeypatch):
    """With no --out the table lands in runs/convergence/ of the working
    directory (never the repository's CONVERGENCE.md): the JAX script's
    printed line and table row for a row (its solver stubbed by a known
    O(h^3) error)."""
    before = open(os.path.join(ROOT, "CONVERGENCE.md")).read()
    row = pcs.ROWS["poisson-resmin-deg2"]
    monkeypatch.setitem(pcs.ROWS, "poisson-resmin-deg2", row[:5] + (
        lambda n, dev, fused: 0.5 / (n - 1) ** 3,))
    monkeypatch.chdir(tmp_path)
    out = pcs.main(["--quick", "--rows", "poisson-resmin-deg2", "--device",
                    "cpu"])
    path = tmp_path / "runs" / "convergence" / "CONVERGENCE.md"
    assert os.path.abspath(out["out"]) == str(path)
    r = out["rows"][0]
    assert r["grids"] == [9, 17] and r["errs"] == [0.5 / 8**3, 0.5 / 16**3]
    assert abs(r["rates"][0] - 3.0) < 1e-12 and len(r["seconds"]) == 2
    text = path.read_text()
    assert ("| Poisson 2D resmin deg2 | 9,17 | 9.77e-04 / 1.22e-04 | 3.00 | "
            "3 (O(h^3)) |") in text
    assert "the CPU" in text
    assert open(os.path.join(ROOT, "CONVERGENCE.md")).read() == before


STUDIES = ("convergence_study", "precision_study", "fps_validation")


@pytest.mark.parametrize("name", STUDIES)
def test_study_source_imports_no_jax(name):
    """No study module imports jax, the JAX package or scripts/."""
    path = os.path.join(ROOT, "diffnet_tpu_torch", "examples", f"{name}.py")
    tree = ast.parse(open(path).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "diffnet_tpu", "scripts", "optax",
                       "flax"}, mods


def test_studies_import_no_jax_at_run_time():
    """Importing the three study modules loads no JAX, no JAX package and
    nothing of scripts/."""
    code = ("import sys\n"
            + "".join(f"import diffnet_tpu_torch.examples.{n}\n"
                      for n in STUDIES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'diffnet_tpu', 'optax', 'flax', 'scripts') "
            "or m in " + repr(STUDIES) + ")\n"
            "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
