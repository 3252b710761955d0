"""Build the port's CUDA sources (``csrc/<name>.cu``) with nvcc for sm_90a
into shared libraries with a plain C interface, and load them with
ctypes for the kernels' wrappers.

A library is built once per source content and flags, into the package's
``_build/`` directory under a name keyed by their hash, so only the first
process of a machine pays the build, and loaded once per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# nvcc's output of each build this process made (ptxas' register and
# shared-memory report), by source name, for the record of a chip run.
build_logs: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into _build/ unless a library of the same
    source and flags is there, and return the library's path. nvcc's
    output goes to build_logs[name] when it built."""
    source = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, source], capture_output=True, text=True,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)
        build_logs[name] = log
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built if need be and loaded once per
    process; at its load each function in `signatures` gets those
    argtypes and returns an int (a cudaError_t)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib
