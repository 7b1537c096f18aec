"""Build and load the port's CUDA library (``csrc/poisson2d.cu``).

The source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``. The build
happens at first use, never at import, into ``diffnet_tpu_torch/_build/``
under a name keyed by a hash of the source and the flags: a changed source
builds anew, an unchanged one is loaded as it is. The compiler writes to a
temporary name that is then renamed, so a half-written library is never
loaded, and two processes building at once do not collide.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "poisson2d.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "poisson_stiffness_action": (_I, [_P, _P, _P, _I, _I, _I] + [_F] * 4
                                 + [_P]),
    "poisson_resmin_loss_grad": (_I, [_P, _P, _P, _LL, _P, _LL, _P, _P, _I,
                                      _I, _I] + [_F] * 4 + [_P]),
    "poisson_energy": (_I, [_P, _P, _P, _P, _I, _I, _I] + [_F] * 7 + [_P]),
    "poisson_resmin_loss_grad_partials": (_LL, [_I, _I, _I]),
    "poisson_energy_partials": (_LL, [_I, _I, _I]),
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
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"poisson2d_{digest[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet. Returns its path and the
    compiler's output (empty when nothing was compiled)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr


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


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        msg = load_library().poisson2d_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{status} ({msg})")
