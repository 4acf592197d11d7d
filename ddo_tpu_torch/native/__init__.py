"""ctypes bindings for the C++ host search runtime: counterpart of
`ddo_tpu/native/__init__.py`.

`ddo_host.cpp` (the port's own copy of ddo_tpu's) holds a
state-deduplicated best-first fringe and a per-depth threshold cache,
with batch entry points so the solver crosses the FFI once per superstep.
It is built with g++ at first use into `ddo_tpu_torch/build/`, as a
library whose name carries a hash of the source, so an edited source is
rebuilt and a stale library never loaded.  There is no fallback: a
failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ddo_tpu_torch.utils.cuda_build import BUILD

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ddo_host.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def build_library(src: str = SRC) -> str:
    """Compile `src` with g++ into BUILD unless its library is there;
    returns the library's path, raises RuntimeError with g++'s output."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    lib = os.path.join(BUILD, f"lib{stem}_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"g++ could not run to build {src}: {e}") from e
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The runtime library, built at first use."""
    lib = ctypes.CDLL(build_library())
    lib.ddo_new.restype = ctypes.c_void_p
    lib.ddo_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ddo_free.argtypes = [ctypes.c_void_p]
    lib.fringe_push_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, I32P, I32P, I32P, I32P, I64P, I32P, U8P,
    ]
    lib.fringe_pop_batch.restype = ctypes.c_int
    lib.fringe_pop_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int32, I32P, I32P, I32P, I32P,
        I32P, U8P, ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.fringe_len.restype = ctypes.c_int
    lib.fringe_len.argtypes = [ctypes.c_void_p]
    lib.fringe_clear.argtypes = [ctypes.c_void_p]
    lib.cache_update_batch.argtypes = [ctypes.c_void_p, ctypes.c_int, I32P, I32P, I32P, U8P]
    lib.cache_must_explore_batch.argtypes = [ctypes.c_void_p, ctypes.c_int, I32P, I32P,
                                             I32P, U8P]
    lib.cache_clear_layer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cache_clear.argtypes = [ctypes.c_void_p]
    return lib


class NativeSearch:
    """The fringe and the threshold cache of one search, in C++: keys are
    `key_cols` int32 columns, paths `n_vars` int32 values and bools."""

    def __init__(self, n_vars: int, key_cols: int):
        self.lib = load()
        self.n = n_vars
        self.K = key_cols
        self.h = self.lib.ddo_new(n_vars, key_cols)

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.ddo_free(self.h)
            self.h = None

    # ---------------------------------------------------------- fringe
    def push_batch(self, keys, depths, values, ubs, scores, path_vals, path_set):
        count = len(depths)
        if count == 0:
            return
        c = np.ascontiguousarray
        self.lib.fringe_push_batch(
            self.h, count, c(keys, np.int32), c(depths, np.int32), c(values, np.int32),
            c(ubs, np.int32), c(scores, np.int64), c(path_vals, np.int32),
            c(path_set, np.uint8))

    def pop_batch(self, max_count: int, best_lb: int):
        """Up to `max_count` entries in (ub, value, score) order, skipping
        those with ub <= best_lb: (keys, depths, values, ubs, path_vals,
        path_set, popped), `popped` counting the skipped entries too."""
        K, n = self.K, self.n
        keys = np.empty((max_count, K), np.int32)
        depths = np.empty(max_count, np.int32)
        values = np.empty(max_count, np.int32)
        ubs = np.empty(max_count, np.int32)
        pvals = np.empty((max_count, n), np.int32)
        pset = np.empty((max_count, n), np.uint8)
        popped = ctypes.c_longlong(0)
        cnt = self.lib.fringe_pop_batch(self.h, max_count, best_lb, keys, depths, values,
                                        ubs, pvals, pset, ctypes.byref(popped))
        return (keys[:cnt], depths[:cnt], values[:cnt], ubs[:cnt], pvals[:cnt],
                pset[:cnt].astype(bool), int(popped.value))

    def __len__(self):
        return self.lib.fringe_len(self.h)

    def clear(self):
        self.lib.fringe_clear(self.h)

    # ----------------------------------------------------------- cache
    def cache_update_batch(self, depths, keys, values, explored):
        count = len(depths)
        if count == 0:
            return
        c = np.ascontiguousarray
        self.lib.cache_update_batch(self.h, count, c(depths, np.int32), c(keys, np.int32),
                                    c(values, np.int32), c(explored, np.uint8))

    def cache_must_explore_batch(self, depths, keys, values):
        count = len(depths)
        out = np.empty(count, np.uint8)
        if count:
            c = np.ascontiguousarray
            self.lib.cache_must_explore_batch(self.h, count, c(depths, np.int32),
                                              c(keys, np.int32), c(values, np.int32), out)
        return out.astype(bool)

    def cache_clear_layer(self, depth: int):
        self.lib.cache_clear_layer(self.h, depth)

    def cache_clear(self):
        self.lib.cache_clear(self.h)
