"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` beside the package (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited source
never loads a stale library). The build runs on first use.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("conditional_fused_rbf", "conditional_fused", "quadform", "cholesky")
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict:
    """Compile every named source that has no current library: all the
    ``nvcc`` jobs start together, then each is waited on. Returns
    ``{name: nvcc output}`` (``None`` for a library that was already
    built); raises if any ``nvcc`` fails."""
    logs, jobs = {}, {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            logs[name] = None
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        # each job's output goes to a file: pipes read one after another
        # could fill and stall a job that is not being read yet
        log = open(f"{tmp}.log", "w+")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        jobs[name] = (so, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, log, proc) in jobs.items():
        proc.wait()
        log.seek(0)
        logs[name] = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry point to its argument types; every
    entry returns an int (a CUDA error code, a size gate or a block count)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            lib.dgp_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dgp_cuda_error_string.restype = ctypes.c_char_p
            for entry, argtypes in signatures.items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.dgp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
