"""Builds the port's hand-written CUDA kernels at first use.

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library, compiled by `nvcc` for Hopper (`sm_90a`) into
`ddo_tpu_torch/build/` and loaded with `ctypes`.  The library's file name
carries a hash of its source and of every `csrc/*.cuh`, so an edited
source is rebuilt and a stale library is never loaded.  `nvcc -Xptxas -v`
reports each kernel's registers, shared memory and spills; the report is
kept beside the library (`ptxas_report`).  Nothing here runs at import
time: the CPU tests import every module on hosts without `nvcc`.

Every kernel wrapper checks its tensors with `check_tensors` (K1 its
strided operands itself) and launches through `launch`, which counts
the launch in `utils/trace.py`'s registry.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from ddo_tpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

#: shared memory one block of an sm_90 card may opt into (bytes)
SMEM_PER_BLOCK = 232_448
#: streaming multiprocessors of an H100 SXM
SM_COUNT = 132


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    """(source, library, ptxas report) of kernel `name`."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.join(BUILD, f"lib{name}_{h.hexdigest()[:16]}")
    return src, stem + ".so", stem + ".ptxas.txt"


def build(*names: str):
    """Compile every named kernel whose library is missing, one `nvcc`
    per source, all started together; raise if any fails."""
    jobs = []
    try:
        for name in names:
            src, lib, report = _paths(name)
            if os.path.exists(lib):
                continue
            os.makedirs(BUILD, exist_ok=True)
            # compile into a temporary name and rename: a concurrent or
            # interrupted build never leaves a half-written library behind
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((src, lib, report, tmp, proc))
        for src, lib, report, tmp, proc in jobs:
            output, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{output}")
            with open(report, "w") as f:
                f.write(output)
            os.replace(tmp, lib)
    finally:
        for _, _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, compiled if missing."""
    build(name)
    return ctypes.CDLL(_paths(name)[1])


def ptxas_report(name: str) -> str:
    """`nvcc -Xptxas -v`'s report for kernel `name` (after `build`)."""
    with open(_paths(name)[2]) as f:
        return f.read()


def check(status: int, what: str):
    """Raise on a non-zero status returned by a kernel's C entry point."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA status {status}")


def launch(name: str, fn, device, *args):
    """`fn(*args, stream)`, a kernel's C entry point, on `device`'s current
    stream; raises on a non-zero status (`check`), else counts one launch
    of `name` (`trace.count`: "<kernel>.<route or part>")."""
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(status, name)
    trace.count(name)


def check_tensors(what: str, args, optional=()):
    """Raise unless every (name, tensor, dtype, shape) of `args` is what
    the kernel reads: a tensor (None only for a name in `optional`) of
    that dtype and shape, contiguous, and on one CUDA device, which it
    returns."""
    for name, x, dtype, shape in args:
        if x is None:
            if name not in optional:
                raise ValueError(f"{what}: {name} is missing")
            continue
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {dtype} {list(shape)}, "
                             f"got {x.dtype} {list(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    device = None
    for name, x, _, _ in args:
        if x is None:
            continue
        if not x.is_cuda or (device is not None and x.device != device):
            raise ValueError(f"{what}: {name} is on {x.device}, not on "
                             f"{device or 'a CUDA device'}")
        device = device or x.device
    return device
