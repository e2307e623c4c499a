"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` beside the package (the hash covers the
source and the flags, so an edited source never loads a stale library).
The build runs on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("conditional_fused_rbf",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict:
    """Compile every named source that has no current library, one blocking
    ``nvcc`` each (there is one source; start the jobs together once there
    are more). Returns ``{name: nvcc output}`` (``None`` for a library that
    was already built); raises if ``nvcc`` fails."""
    logs = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            logs[name] = None
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs[name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            lib.dgp_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dgp_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.dgp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
