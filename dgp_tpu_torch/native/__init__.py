"""Native (C++) Pareto utilities with a numpy fallback (counterpart of
``dgp_tpu/native``).

``nd_sort_2d`` takes the BO archive bookkeeping (the feasibility-filtered
non-dominated sort, an O(n^2) Python loop in
:func:`dgp_tpu_torch.bo.ehvi._ndc_numpy`) to an O(n log n) sweep in
``pareto.cpp``, the port's own copy of the JAX package's source;
``bo.ehvi.NDC`` dispatches archives of 512 rows or more to it. The
library's 2-D hypervolume (:func:`hv_2d`) is public, as in the JAX
package, but nothing in the port calls it: it differs from ``HV_calcul``
on out-of-box fronts. This is host code, not a device
kernel: the archive lives in numpy on the host.

The library builds on first use with ``g++ -O3 -fPIC -shared -std=c++17``
into ``build/libpareto-<hash>.so`` beside the package (the hash covers the
source and the flags, as ``_build.library_path`` names the CUDA libraries)
and loads with ctypes. Where ``g++`` or the build is missing, every
function falls back to the numpy versions in ``bo/ehvi.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from .._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pareto.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
_LIB = None
_TRIED = False


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpareto-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``pareto.cpp`` unless its library is current; returns the
    library's path. Raises where ``g++`` is missing or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native Pareto sweep needs a C++ "
                           "compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(build())
        lib.nd_sort_2d.restype = ctypes.c_int64
        lib.nd_sort_2d.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.hv_2d.restype = ctypes.c_double
        lib.hv_2d.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _objectives(Y):
    """The two objective columns as one contiguous [n, 2] float64 array."""
    return np.ascontiguousarray(
        np.concatenate((np.asarray(Y[0]).reshape(-1, 1),
                        np.asarray(Y[1]).reshape(-1, 1)), axis=1),
        dtype=np.float64)


def nd_sort_2d(Y, C, obj1_ascending=True):
    """Drop-in for ``bo.ehvi.NDC`` (2 objectives, minimization)."""
    lib = _load()
    if lib is None:
        from ..bo.ehvi import _ndc_numpy

        return _ndc_numpy(Y, C, obj1_ascending=obj1_ascending)
    y = _objectives(Y)
    n = y.shape[0]
    feasible = np.ascontiguousarray(
        (np.asarray(C).reshape(n, -1).max(axis=1) <= 0).astype(np.uint8))
    out = np.empty(n, dtype=np.int64)
    count = lib.nd_sort_2d(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        feasible.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    nd = [int(i) for i in out[:count]]
    return nd if obj1_ascending else nd[::-1]


def hv_2d(ND, Y, bounds):
    """Fast path for ``bo.ehvi.HV_calcul`` **assuming an in-box front**:
    points of ``ND`` outside the (U1, U2) reference corner are skipped and
    the rest summed, whereas HV_calcul returns 0 for the whole front when
    any ND point exceeds both bounds and zeroes segments per its staircase
    quirks. Callers with possibly out-of-box fronts must use HV_calcul."""
    lib = _load()
    if lib is None:
        from ..bo.ehvi import HV_calcul

        return HV_calcul(ND, Y, bounds)
    _, _, u1, u2 = bounds
    y = _objectives(Y)
    nd = np.ascontiguousarray(np.asarray(ND, dtype=np.int64))
    if nd.size == 0:
        return 0.0
    return float(lib.hv_2d(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nd.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nd.size, float(u1), float(u2),
    ))
