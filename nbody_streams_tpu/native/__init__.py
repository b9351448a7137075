"""Native host-runtime kernels (C++/OpenMP via ctypes).

Loads ``libnbody_host.so`` (built with ``make`` in this directory or via
:func:`build`); every entry point has a NumPy/SciPy fallback so the
package works unbuilt.  This is the framework's host-native layer — the
device compute path is Pallas/XLA (see ops/), mirroring the reference's
split between its CUDA .so and Python host code.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "build", "morton_argsort", "knn_radius"]

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libnbody_host.so"
_lib = None
_autobuild_tried = False


def _autobuild():
    """Lazy one-shot ``make`` when the library is missing or older than
    its source (reference analogue: tree_gpu/_build.py:27 builds
    libtreeGPU.so on demand).  Without it the N>=500k kNN fast path in
    viz/sph.py silently never fires for pip/checkout users.  Guarded by
    NBODY_NO_NATIVE_BUILD=1 (containers without a toolchain lose ~a
    subprocess attempt, nothing else — every caller has a NumPy/SciPy
    fallback)."""
    global _autobuild_tried
    if _autobuild_tried:
        return
    _autobuild_tried = True
    import os

    if os.environ.get("NBODY_NO_NATIVE_BUILD"):
        return
    stale = False
    if _LIB_PATH.exists():
        try:
            src = (_DIR / "host_ops.cpp").stat().st_mtime
            stale = src > _LIB_PATH.stat().st_mtime
        except OSError:
            stale = False
    if not _LIB_PATH.exists() or stale:
        try:
            subprocess.run(["make", "-C", str(_DIR)],
                           capture_output=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            pass


def _load():
    global _lib
    if _lib is not None:
        return _lib
    _autobuild()   # one-shot; also refreshes a stale build
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.morton_argsort.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.knn_radius.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ]
        lib.nbody_host_alive.restype = ctypes.c_int
        if lib.nbody_host_alive() != 1:
            return None
        _lib = lib
        return lib
    except (OSError, AttributeError):
        # AttributeError: a stale/partial .so missing a symbol (ctypes
        # dlsym) must fall back, same as a missing/unloadable library
        return None


def native_available() -> bool:
    return _load() is not None


def build(verbose: bool = True) -> bool:
    """Compile libnbody_host.so in place (requires g++)."""
    try:
        out = subprocess.run(["make", "-C", str(_DIR)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        if verbose:
            print(f"native build failed to launch: {exc}")
        return False
    if out.returncode != 0:
        if verbose:
            print(out.stdout)
            print(out.stderr)
        return False
    global _lib
    _lib = None
    ok = native_available()
    if verbose:
        print("native build:", "ok" if ok else "load failed")
    return ok


def _check_pos3(pos) -> np.ndarray:
    """Validate/contiguate an (N, 3) position buffer before handing its
    raw pointer to the C library — a (N, 2) array would be read 3N
    doubles deep (out-of-bounds heap read / segfault)."""
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(
            f"positions must be (N, 3), got {pos.shape}; pad 2-D data "
            "with a zero column")
    return pos


def morton_argsort(pos) -> np.ndarray:
    """Z-order (Morton) spatial sort permutation for (N, 3) positions.

    Native path: OpenMP key construction + std::sort (the reference does
    this in NumPy at 50-150 ms / 5M particles, sph_kernels.py:78-80);
    fallback: NumPy bit-interleave.
    """
    pos = _check_pos3(pos)
    n = pos.shape[0]
    lib = _load()
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        lib.morton_argsort(
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(n),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out
    # NumPy fallback: 21-bit interleaved keys
    lo = pos.min(0)
    span = np.maximum(pos.max(0) - lo, 1e-300)
    q = ((pos - lo) / span * ((1 << 21) - 1)).astype(np.uint64)

    def spread(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | v << np.uint64(32)) & np.uint64(0x1F00000000FFFF)
        v = (v | v << np.uint64(16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | v << np.uint64(8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | v << np.uint64(4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | v << np.uint64(2)) & np.uint64(0x1249249249249249)
        return v

    keys = (spread(q[:, 0]) | spread(q[:, 1]) << np.uint64(1)
            | spread(q[:, 2]) << np.uint64(2))
    return np.argsort(keys, kind="stable")


def knn_radius(pos, k: int = 32) -> np.ndarray:
    """Distance to the k-th nearest neighbour for each (N, 3) point.

    Native path: OpenMP grid-hash search; fallback: SciPy cKDTree.
    """
    pos = _check_pos3(pos)
    n = pos.shape[0]
    lib = _load()
    if lib is not None:
        out = np.empty(n, dtype=np.float64)
        lib.knn_radius(
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(n), ctypes.c_int(int(k)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out
    if n <= 1:
        # degenerate: no neighbours (match the native path's 0.0)
        return np.zeros(n, dtype=np.float64)
    from scipy.spatial import cKDTree

    tree = cKDTree(pos)
    d, _ = tree.query(pos, k=min(k + 1, n))
    return d[:, -1]
