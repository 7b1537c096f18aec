#!/usr/bin/env python3
"""Run some of chip_smoke.py's slices on one NVIDIA GPU, each on its own
and timed, from the chip_smoke.py of a given checkout: to time a slice
before and after a change in one call, on one card.

    python3 chip_slices.py [--root DIR] [--tag NAME] SLICE [SLICE ...]

SLICE is a slice function's name after ``slice_`` (``a``, ``e1``, ``g2``,
``k``, ``l1`` ... ``l5``, ``m1``, ``m2``, ``p``, ``r1`` ...) or a phase
function's whole name (``phase_k5``: a kernel against its plain version at
every shape chip_smoke checks it at). ``--root``
names the checkout whose chip_smoke.py and ``diffnet_tpu_torch`` run (by
default this one's; an unpacked ``git archive`` of another commit, say).
The kernels are built first (chip_smoke's build phase). Each slice prints
its own JSON lines, then one line ``{"slice", "tag", "ok", "seconds",
"error"}``; a slice that fails is reported and the next one runs. Exits 1
if any slice failed, and without CUDA."""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the checkout to run")
    ap.add_argument("--tag", default="", help="a name for the lines")
    ap.add_argument("slices", nargs="+")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("chip_slices: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda:0")
    smi = smoke.phase_device(dev)
    smoke.phase_build()
    failed = 0
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        given = {"dev": dev, "smi": smi, "paths": {}, "tmp": tmp}
        for name in args.slices:
            fn = getattr(smoke, name if name.startswith("phase_")
                         else f"slice_{name.lower()}")
            kwargs = {k: given[k] for k in inspect.signature(fn).parameters}
            t0 = time.perf_counter()
            error = None
            try:
                fn(**kwargs)
                torch.cuda.synchronize()
            except Exception as e:   # report it, run the next slice
                error = f"{type(e).__name__}: {e}"
                failed += 1
            print(json.dumps({"slice": name, "tag": args.tag,
                              "ok": error is None,
                              "seconds": time.perf_counter() - t0,
                              "error": error}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
