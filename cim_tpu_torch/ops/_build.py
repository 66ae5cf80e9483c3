"""Build the package's CUDA sources with nvcc and load them with ctypes.

Mirrors cim_tpu/native, which does the same for its host C++ with g++:
each ``csrc/<name>.cu`` is compiled at first use into a shared library
with a plain C interface, under ``cim_tpu_torch/_build/``, named by a hash
of the source, the shared headers ``csrc/*.cuh`` and the flags, so that an
edited source or header builds anew. No PyTorch headers are involved, so a
build takes seconds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "of cim_tpu_torch need the CUDA toolkit to build"
        )
    return path


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a library of the same source, headers
    and flags exists; returns the library's path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    return lib_path


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if it is not yet."""
    return ctypes.CDLL(build(name))
