"""Build and load the port's CUDA library (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source, all started together, so a build takes as long as its slowest
source however many sources are added; the objects are then linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, never at import, into ``diffnet_tpu_torch/_build/``
under a name keyed by a hash of the sources and the flags: a changed source
builds anew, an unchanged one is loaded as it is. The objects go to a
temporary directory and the library to a temporary name that is then
renamed, so a half-written library is never loaded, and two processes
building at once do not collide.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "LINK_FLAGS", "SOURCES", "build", "load_library",
           "sm_count"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "poisson2d.cu", "stencil2d.cu", "poisson3d.cu", "stencil3d.cu",
    "ns2d.cu"))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-c")
LINK_FLAGS = ("-shared",)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "poisson_stiffness_action": (_I, [_P, _P, _P] + [_I] * 5 + [_F] * 4
                                 + [_P]),
    "poisson_resmin_loss_grad": (_I, [_P, _P, _P, _LL, _P, _LL, _P, _P]
                                 + [_I] * 4 + [_F] * 4 + [_P]),
    "poisson_energy": (_I, [_P, _P, _P, _P] + [_I] * 5 + [_F] * 7 + [_P]),
    "poisson_resmin_loss_grad_partials": (_LL, [_I] * 4),
    "poisson_energy_partials": (_LL, [_I] * 4),
    "stencil_apply_2d": (_I, [_P, _LL, _P, _P, _I, _I, _I, _I, _P]),
    "poisson_stiffness_action_3d": (_I, [_P, _P, _P, _I, _I, _I, _I, _I]
                                    + [_F] * 7 + [_P]),
    "stencil_apply_3d": (_I, [_P, _LL, _P, _P, _I, _I, _I, _I, _I, _P]),
    "ns_vms_residual": (_I, [_P] * 8 + [_I] * 5 + [_F] * 18 + [_P]),
    "poisson2d_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "diffnet_tpu_torch need the CUDA toolkit")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"diffnet_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list[subprocess.Popen]) -> str:
    """Wait for every process; raise with their output if one failed."""
    outs = [p.communicate() for p in procs]
    log = "".join(o + e for o, e in outs)
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"nvcc failed ({bad[0]}):\n{log}")
    return log


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet. Returns its path and the
    compiler's output (empty when nothing was compiled)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [Path(objdir) / f"{src.stem}.o" for src in SOURCES]
        try:
            log = _run([subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for src, obj in zip(SOURCES, objs)])
            log += _run([subprocess.Popen(
                [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
    os.replace(tmp, so)
    return so, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry point's
    argument and result types declared."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


@functools.cache
def _sms(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels with a
    per-launch tiling choice size it by them)."""
    import torch

    index = device.index
    return _sms(torch.cuda.current_device() if index is None else index)


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        msg = load_library().poisson2d_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{status} ({msg})")
