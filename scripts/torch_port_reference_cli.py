#!/usr/bin/env python3
"""The JAX package's example CLIs at the configurations that the PyTorch
port's entry-point check (chip_smoke.py's slice P) runs them at.

Runs each JAX CLI in-process on the CPU, with its output directory under a
temporary directory, and prints one JSON line per entry: the argv, the
CLI's last printed line, the headline figure parsed from it, and the
seconds.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_cli.py P2
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_cli.py P1 P3

``P2-K1`` is P2 with the stiffness kernel switched on in every Poisson2D
the CLI builds (``fused_kernels=True``, the Pallas kernel in interpret
mode), as the port's CLI runs P2 with ``--fused-kernels``: at 513^2 the
float32 rounding of the unfused residual sets the JAX CLI's figure
(4.1e-4), the kernel's form reaches the discretisation error (3.2e-6),
and MG-CG gets there in ~20 iterations. The JAX CLI has no such flag, so
the script swaps ``diffnet_tpu.pde.Poisson2D`` for the run (~260 s on a
CPU, the kernel interpreted):

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_cli.py P2-K1

chip_smoke.py keeps its own copy of the figures (it imports no JAX).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

ENTRIES = {
    "P1": ("examples/poisson_mms_2d.py",
           ["--domain-size", "64", "--loss-type", "resmin", "--optimizer",
            "lbfgs", "--max-epochs", "80"], r"rel_L2: (\S+)"),
    "P2": ("examples/poisson_mms_2d.py",
           ["--domain-size", "513", "--optimizer", "mg-cg"],
           r"rel_L2: (\S+)"),
    "P3": ("examples/poisson_3d.py",
           ["--domain-size", "17", "--max-epochs", "60"], r"rel_L2: (\S+)"),
}
ENTRIES["P2-K1"] = ENTRIES["P2"]


@contextlib.contextmanager
def _k1():
    """Every Poisson2D with its stiffness kernel (Pallas, interpreted)."""
    from functools import partial

    import diffnet_tpu.pde as pde
    from jax.experimental import pallas as pl

    saved = pde.Poisson2D, pl.pallas_call

    class Fused(saved[0]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "fused_kernels": True})

    pde.Poisson2D = Fused
    pl.pallas_call = partial(saved[1], interpret=True)
    try:
        yield
    finally:
        pde.Poisson2D, pl.pallas_call = saved


def run(name: str) -> dict:
    script, argv, pattern = ENTRIES[name]
    spec = importlib.util.spec_from_file_location(
        "cli_" + name, os.path.join(ROOT, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fused = _k1() if name.endswith("-K1") else contextlib.nullcontext()
    with tempfile.TemporaryDirectory() as tmp:
        old, buf = sys.argv, io.StringIO()
        sys.argv = [script] + argv + ["--out-dir", tmp]
        t0 = time.perf_counter()
        try:
            with fused, contextlib.redirect_stdout(buf):
                mod.main()
        finally:
            sys.argv = old
        seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    found = [re.search(pattern, ln) for ln in lines]
    figure = next(float(m.group(1)) for m in reversed(found) if m)
    return {"entry": name, "script": script, "argv": argv,
            "last_line": lines[-1], "figure": figure, "seconds": seconds}


if __name__ == "__main__":
    for name in sys.argv[1:] or sorted(ENTRIES):
        print(json.dumps(run(name)), flush=True)
