"""Per-lane lexicographic multi-key sort: counterpart of
`ddo_tpu/ops/sort_pallas.py` (`multi_sort`, `sort_packed`, `sort_lanes`).

Contract (lax.sort(ops, num_keys, is_stable=False) per lane): operands
are int32 [L, C] tensors; each lane (row) is sorted independently,
ascending and lexicographic on the first `num_keys` operands, with the
remaining operands riding as payload.  Engine call sites always supply a
unique final key, so the order is total and any correct sort gives the
same result.

On a CUDA tensor every entry point launches kernel K1
(`csrc/lane_sort.cu`, one CTA per lane, bitonic network over an index
permutation in shared memory) or raises; on a CPU tensor it runs the
plain version `multi_sort_plain` (successive stable `torch.sort`s, last
key first).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ddo_tpu_torch.utils import cuda_build

#: launches of kernel K1 since import (a run reads it to show the main
#: path went through the kernel)
KERNEL_LAUNCHES = 0


def multi_sort_plain(operands, num_keys):
    """Plain PyTorch version: a stable lexsort (stable sorts from the last
    key to the first), then one gather per operand."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key.gather(1, perm)
        idx = torch.sort(k, dim=1, stable=True).indices
        perm = idx if perm is None else perm.gather(1, idx)
    return tuple(o.gather(1, perm) for o in operands)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("lane_sort")
    lib.lane_sort.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.lane_sort.restype = ctypes.c_int
    return lib


def multi_sort_cuda(operands, num_keys):
    """Kernel K1 on CUDA tensors; raises on what the kernel does not take."""
    global KERNEL_LAUNCHES
    first = operands[0]
    L, C = first.shape
    for o in operands:
        if not o.is_cuda or o.device != first.device:
            raise ValueError("lane_sort: every operand must be on one CUDA device")
        if o.dtype != torch.int32 or tuple(o.shape) != (L, C):
            raise ValueError(f"lane_sort: operands must be int32 [{L}, {C}]")
    n = len(operands)
    if not 1 <= num_keys <= n:
        raise ValueError(f"lane_sort: num_keys={num_keys} not in [1, {n}]")
    # the kernel reads one contiguous [n, L, C] array, any n
    stacked = torch.stack(operands)
    out = torch.empty_like(stacked)
    if L == 0 or C == 0:
        return tuple(out.unbind(0))
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().lane_sort(stacked.data_ptr(), out.data_ptr(), n, num_keys, L, C,
                                  stream)
    if status == -1:
        raise ValueError(
            f"lane_sort: {num_keys} keys of C={C} rows (padded to a power of "
            "two) exceed the shared memory of one block")
    cuda_build.check(status, "lane_sort")
    KERNEL_LAUNCHES += 1
    return tuple(out.unbind(0))


def multi_sort(operands, num_keys):
    """Engine sort: K1 for CUDA tensors, the plain version for CPU ones."""
    operands = tuple(operands)
    if operands[0].is_cuda:
        return multi_sort_cuda(operands, num_keys)
    if operands[0].device.type != "cpu":
        raise ValueError(f"multi_sort: no route for device {operands[0].device}")
    return multi_sort_plain(operands, num_keys)


def sort_packed(operands, num_keys):
    """`ddo_tpu.ops.sort_pallas.sort_packed`'s contract (any C; a list in,
    a list out) through `multi_sort`."""
    return list(multi_sort(operands, num_keys))


def sort_lanes(operands, num_keys):
    """`ddo_tpu.ops.sort_pallas.sort_lanes`'s contract (C a power of two)
    through `multi_sort`.  With tied keys only the key operands are
    determined; payload order within ties is the sort's own."""
    C = operands[0].shape[-1]
    if C & (C - 1):
        raise ValueError("sort_lanes: C must be a power of two")
    return list(multi_sort(operands, num_keys))
