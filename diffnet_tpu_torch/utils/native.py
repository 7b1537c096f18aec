"""ctypes binding to the repository's host preprocessing library,
``csrc/diffnet_host.cpp`` (the port's own binding; the JAX package has its
counterpart in ``diffnet_tpu/utils/native.py``).

The library does host-side dataset synthesis on CPU threads: KL
diffusivity-field batches (:func:`kl_diffusivity_batch`), the loader's
batch gather (:func:`gather_batch`) and generalized winding numbers
(:func:`winding_number_2d_host`, :func:`winding_number_3d_host`).

It is built at first use with ``g++ -O3 -fopenmp`` into
``diffnet_tpu_torch/_build/`` (compiled to a private temporary file, then
renamed into place, so a process that loads it concurrently never sees a
half-written library). A failed build or load raises ``RuntimeError`` with
the compiler's output: there is no silent fallback. The numpy versions of
each entry point (``*_plain``) compute the same results; callers choose
them explicitly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "load_library", "kl_diffusivity_batch",
           "kl_diffusivity_batch_plain", "gather_batch",
           "gather_batch_plain", "winding_number_2d_host",
           "winding_number_2d_host_plain", "winding_number_3d_host",
           "winding_number_3d_host_plain"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.normpath(os.path.join(_HERE, "..", "..", "csrc",
                                       "diffnet_host.cpp"))
LIB_PATH = os.path.normpath(os.path.join(_HERE, "..", "_build",
                                         "libdiffnet_host.so"))
CXX = "g++"          # the compiler the library is built with
_lib = None
_lock = threading.Lock()


def _build() -> None:
    """Compile SOURCE into LIB_PATH; raises with the compiler's output."""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [CXX, "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           SOURCE, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native: could not run {' '.join(cmd)}: {e}") \
            from e
    try:
        if r.returncode != 0:
            raise RuntimeError(
                f"native: {' '.join(cmd)} failed (exit {r.returncode}):\n"
                f"{r.stderr}{r.stdout}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library():
    """The loaded library, built first when it is missing or older than
    its source. Raises RuntimeError when the build or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        fresh = (os.path.exists(LIB_PATH)
                 and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE))
        if not fresh:
            _build()
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:
            raise RuntimeError(f"native: could not load {LIB_PATH}: {e}") \
                from e
        i64, dbl = ctypes.c_int64, ctypes.c_double
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.dn_kl_diffusivity_2d.argtypes = [f64p, dbl, f64p, i64, i64, i64,
                                             f32p]
        for fn in (lib.dn_winding_2d, lib.dn_winding_3d):
            fn.argtypes = [f32p, f32p, f32p, i64, i64, f32p, i64, f32p]
        lib.dn_gather_rows.argtypes = [u8p, i64p, i64, i64, u8p]
        for fn in (lib.dn_kl_diffusivity_2d, lib.dn_winding_2d,
                   lib.dn_winding_3d, lib.dn_gather_rows):
            fn.restype = None
        lib.dn_num_threads.argtypes = []
        lib.dn_num_threads.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """True when the library builds and loads."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def _kl_coeffs(coeffs, n_sum_nu: int) -> np.ndarray:
    """Rows of six terms: padded with zeros, those past `n_sum_nu` zeroed
    (``generate_diffusivity_tensor``'s rule)."""
    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    c6 = np.zeros((coeffs.shape[0], 6))
    k = min(6, coeffs.shape[1], n_sum_nu)
    c6[:, :k] = coeffs[:, :k]
    return c6


def kl_diffusivity_batch(coeffs, n: int, eta: float = 0.5,
                         n_sum_nu: int = 6) -> np.ndarray:
    """``exp(KL_sum_2D)`` diffusivity fields ``[B, n, n]`` float32 of
    coefficient rows ``[B, k]``: ``generate_diffusivity_tensor`` applied to
    each row, with correlation length `eta`, on OpenMP threads."""
    from ..data.gen_input import calculate_omega_based_on_eta

    c6 = _kl_coeffs(coeffs, n_sum_nu)
    lib = load_library()
    omega = np.ascontiguousarray(
        calculate_omega_based_on_eta(float(eta))[:6], np.float64)
    out = np.empty((c6.shape[0], n, n), np.float32)
    lib.dn_kl_diffusivity_2d(omega, float(eta), np.ascontiguousarray(c6),
                             c6.shape[0], n, 6, out)
    return out


def kl_diffusivity_batch_plain(coeffs, n: int, eta: float = 0.5,
                               n_sum_nu: int = 6) -> np.ndarray:
    """numpy version of :func:`kl_diffusivity_batch` (float64 sums, the
    result rounded to float32)."""
    from ..data.gen_input import construct_KL_sum_2D, grid2D

    xv, yv = grid2D(n, n)
    return np.stack([
        np.exp(construct_KL_sum_2D(xv, yv, c, eta_x=eta, eta_y=eta))
        for c in _kl_coeffs(coeffs, n_sum_nu)]).astype(np.float32)


def _gather_args(src, idx):
    src = np.ascontiguousarray(src)
    if src.dtype.hasobject:
        raise TypeError("gather_batch: arrays of Python objects cannot be "
                        "copied as bytes")
    idx = np.ascontiguousarray(np.asarray(idx, np.int64))
    if idx.ndim != 1:
        raise ValueError(f"gather_batch: idx must be 1-d, got {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError("gather_batch index out of range")
    return src, idx


def gather_batch(src: np.ndarray, idx) -> np.ndarray:
    """``src[idx]`` for a row-major sample store of any dtype and trailing
    shape: one memcpy a sample, on OpenMP threads. `idx` is 1-d and
    non-negative."""
    src, idx = _gather_args(src, idx)
    lib = load_library()
    out = np.empty((idx.size,) + src.shape[1:], src.dtype)
    if idx.size == 0:
        return out
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    lib.dn_gather_rows(src.view(np.uint8).reshape(src.shape[0], -1), idx,
                       idx.size, row_bytes,
                       out.view(np.uint8).reshape(idx.size, -1))
    return out


def gather_batch_plain(src: np.ndarray, idx) -> np.ndarray:
    """numpy version of :func:`gather_batch`."""
    src, idx = _gather_args(src, idx)
    return src[idx]


def _as_batched(points, normals, areas, queries, nsd):
    p = np.asarray(points, np.float32)
    if p.ndim == 2:
        p = p[None]
    if p.shape[-1] != nsd:
        raise ValueError(f"winding_number_{nsd}d_host: points must be "
                         f"[B, P, {nsd}], got {p.shape}")
    nrm = np.asarray(normals, np.float32).reshape(p.shape)
    a = np.asarray(areas, np.float32).reshape(p.shape[:2])
    q = np.asarray(queries, np.float32)
    if q.ndim != 2 or q.shape[1] != nsd:
        raise ValueError(f"winding_number_{nsd}d_host: queries must be "
                         f"[Q, {nsd}], got {q.shape}")
    return tuple(np.ascontiguousarray(x) for x in (p, nrm, a, q))


def _winding_host(points, normals, areas, queries, nsd):
    p, nrm, a, q = _as_batched(points, normals, areas, queries, nsd)
    lib = load_library()
    out = np.empty((p.shape[0], q.shape[0]), np.float32)
    fn = lib.dn_winding_2d if nsd == 2 else lib.dn_winding_3d
    fn(p, nrm, a, p.shape[0], p.shape[1], q, q.shape[0], out)
    return out


def _winding_plain(points, normals, areas, queries, nsd):
    p, nrm, a, q = _as_batched(points, normals, areas, queries, nsd)
    out = np.empty((p.shape[0], q.shape[0]), np.float32)
    eps = np.float32(1e-8)
    for b in range(p.shape[0]):
        d = p[b][None, :, :] - q[:, None, :]            # [Q, P, nsd]
        dot = np.sum(d * nrm[b][None], axis=-1)
        r2 = np.sum(d * d, axis=-1)
        if nsd == 2:
            out[b] = np.sum(a[b][None] * dot / (2 * np.pi * (r2 + eps)), -1)
        else:
            r = np.sqrt(r2 + eps)
            out[b] = np.sum(a[b][None] * dot / (4 * np.pi * r**3), -1)
    return out


def winding_number_2d_host(points, normals, areas, queries) -> np.ndarray:
    """Generalized winding number of 2D clouds on CPU threads:
    ``[B?, P, 2] x [Q, 2] -> [B, Q]`` (the math of
    ``core.geometry.winding_number_2d``)."""
    return _winding_host(points, normals, areas, queries, 2)


def winding_number_2d_host_plain(points, normals, areas,
                                 queries) -> np.ndarray:
    """numpy version of :func:`winding_number_2d_host`."""
    return _winding_plain(points, normals, areas, queries, 2)


def winding_number_3d_host(points, normals, areas, queries) -> np.ndarray:
    """Generalized winding number (solid angle) of 3D clouds on CPU
    threads: ``[B?, P, 3] x [Q, 3] -> [B, Q]``."""
    return _winding_host(points, normals, areas, queries, 3)


def winding_number_3d_host_plain(points, normals, areas,
                                 queries) -> np.ndarray:
    """numpy version of :func:`winding_number_3d_host`."""
    return _winding_plain(points, normals, areas, queries, 3)
