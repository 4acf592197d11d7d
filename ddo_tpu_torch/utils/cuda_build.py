"""Builds the port's hand-written CUDA kernels at first use.

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library, compiled by `nvcc` for Hopper (`sm_90a`) into
`ddo_tpu_torch/build/` and loaded with `ctypes`.  The library's file name
carries a hash of its source, so an edited source is rebuilt and a stale
library is never loaded.  Nothing here runs at import time: the CPU tests
import every module on hosts without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, compiled if missing."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD, f"lib{name}_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD, exist_ok=True)
        # compile into a temporary name and rename: a concurrent or
        # interrupted build never leaves a half-written library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, lib)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed on {src}:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(lib)


def check(status: int, what: str):
    """Raise on a non-zero status returned by a kernel's C entry point."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA status {status}")
