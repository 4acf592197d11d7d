"""Per-lane lexicographic multi-key sort: counterpart of
`ddo_tpu/ops/sort_pallas.py` (`multi_sort`, `sort_packed`, `sort_lanes`).

Contract (lax.sort(ops, num_keys, is_stable=False) per lane): operands
are int32 [L, C] tensors; each lane (row) is sorted independently,
ascending and lexicographic on the first `num_keys` operands, with the
remaining operands riding as payload.  Engine call sites always supply a
unique final key, so the order is total and any correct sort gives the
same result.

On a CUDA tensor every entry point launches kernel K1
(`csrc/lane_sort.cu`) or raises; K1 has three routes, chosen by shape
(`lane_sort_route`): "regs", a bitonic network held in registers and warp
shuffles, one CTA per lane; "perm", a network over an index permutation
in shared memory, one CTA per lane, for more keys or longer lanes; and
"merge", a merge sort of row positions over many CTAs per lane through a
device workspace, for lanes whose keys pass one block's shared memory.
On a CPU tensor it runs the plain version `multi_sort_plain` (successive
stable `torch.sort`s, last key first).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ddo_tpu_torch.utils import cuda_build

#: calls of kernel K1 since import, one per `multi_sort_cuda` call on any
#: route (a run reads it to show the main path went through the kernel)
KERNEL_LAUNCHES = 0
#: the same calls by route
ROUTE_LAUNCHES = {"regs": 0, "perm": 0, "merge": 0}

#: operands one call takes (LS_MAX_OPS in csrc/lane_sort.cu)
MAX_OPERANDS = 128
#: rows per lane the "merge" route takes (int32 positions and tile
#: offsets, with room to round up to a tile)
MERGE_MAX_ROWS = 1 << 30
#: the "regs" route's largest key count and padded lane length
#: (LS_NK_MAX, LS_C2_MAX: 1024 threads x 2 rows)
REGS_MAX_KEYS = 8
REGS_MAX_ROWS = 2048


class _SortArgs(ctypes.Structure):
    """`SortArgs` of csrc/lane_sort.cu: each operand's pointer and its
    lane and row strides (elements), handed to the kernel by value."""

    _fields_ = [("ptr", ctypes.c_void_p * MAX_OPERANDS),
                ("rs", ctypes.c_int64 * MAX_OPERANDS),
                ("cs", ctypes.c_int64 * MAX_OPERANDS)]


def multi_sort_plain(operands, num_keys):
    """Plain PyTorch version: a stable lexsort (stable sorts from the last
    key to the first), then one gather per operand."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key.gather(1, perm)
        idx = torch.sort(k, dim=1, stable=True).indices
        perm = idx if perm is None else perm.gather(1, idx)
    return tuple(o.gather(1, perm) for o in operands)


def _fits(route: str, num_keys: int, C: int) -> bool:
    """Whether K1's `route` takes `num_keys` keys over lanes of C rows."""
    C2 = 1 << max(1, (C - 1).bit_length())
    if route == "regs":
        return num_keys <= REGS_MAX_KEYS and C2 <= REGS_MAX_ROWS
    if route == "perm":
        return (num_keys + 1) * C2 * 4 <= cuda_build.SMEM_PER_BLOCK
    return route == "merge" and C <= MERGE_MAX_ROWS


def lane_sort_route(num_keys: int, C: int) -> str:
    """K1's route for `num_keys` keys over lanes of C rows: "regs" when
    the keys fit its registers (num_keys <= REGS_MAX_KEYS) and C, padded
    to a power of two, to its threads (<= REGS_MAX_ROWS); else "perm"
    while a lane's keys and permutation fit one block's shared memory;
    else "merge".  Raises only past MAX_OPERANDS keys or MERGE_MAX_ROWS
    rows."""
    if num_keys > MAX_OPERANDS:
        raise ValueError(f"lane_sort: {num_keys} keys exceed the {MAX_OPERANDS} operands "
                         "one call takes")
    for route in ("regs", "perm", "merge"):
        if _fits(route, num_keys, C):
            return route
    raise ValueError(f"lane_sort: C={C} rows exceed the {MERGE_MAX_ROWS} rows of the "
                     "merge route")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("lane_sort")
    for fn in (lib.lane_sort_regs, lib.lane_sort_perm):
        fn.argtypes = [ctypes.POINTER(_SortArgs), ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.lane_sort_merge.argtypes = [ctypes.POINTER(_SortArgs), ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lane_sort_merge.restype = ctypes.c_int
    return lib


def multi_sort_cuda(operands, num_keys, route=None):
    """Kernel K1 on CUDA tensors (any strides), with one output allocation
    (and, on the "merge" route, one int32 [2, L, C] workspace from the
    caching allocator); raises on what the kernel does not take.  `route`
    ("regs", "perm" or "merge") overrides `lane_sort_route`'s choice, so
    that a comparison can run several on one shape."""
    global KERNEL_LAUNCHES
    n = len(operands)
    if n > MAX_OPERANDS:
        raise ValueError(f"lane_sort: {n} operands exceed the {MAX_OPERANDS} one launch takes")
    if not 1 <= num_keys <= n:
        raise ValueError(f"lane_sort: num_keys={num_keys} not in [1, {n}]")
    first = operands[0]
    L, C = first.shape
    route = route or lane_sort_route(num_keys, C)
    if route not in ROUTE_LAUNCHES or not _fits(route, num_keys, C):
        raise ValueError(f"lane_sort: route {route!r} does not take {num_keys} keys "
                         f"of C={C} rows")
    for o in operands:
        if not o.is_cuda or o.device != first.device:
            raise ValueError("lane_sort: every operand must be on one CUDA device")
        if o.dtype != torch.int32 or tuple(o.shape) != (L, C):
            raise ValueError(f"lane_sort: operands must be int32 [{L}, {C}]")
    out = torch.empty((n, L, C), dtype=torch.int32, device=first.device)
    if L == 0 or C == 0:
        return tuple(out.unbind(0))
    args = _SortArgs()
    for t, o in enumerate(operands):
        args.ptr[t] = o.data_ptr()
        args.rs[t], args.cs[t] = o.stride()
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "merge":
            ws = torch.empty((2, L, C), dtype=torch.int32, device=first.device)
            status = _lib().lane_sort_merge(ctypes.byref(args), out.data_ptr(), ws.data_ptr(),
                                            n, num_keys, L, C, stream)
        else:
            fn = _lib().lane_sort_regs if route == "regs" else _lib().lane_sort_perm
            status = fn(ctypes.byref(args), out.data_ptr(), n, num_keys, L, C, stream)
    cuda_build.check(status, f"lane_sort ({route})")
    KERNEL_LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
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
