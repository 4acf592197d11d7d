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
(`lane_sort_route`): "regs" and "perm", one bitonic network held in
registers and warp shuffles, one CTA per lane ("regs" up to 8 key words,
"perm" up to 12 in registers and the rest staged in shared memory); and
"merge", a merge sort over many CTAs per lane whose tiles and merge
windows are staged in shared memory, with records of the first 12 key
words and the position moving through a device workspace, and a gather
pass for the payloads (`merge_plan`).  On a CPU tensor it runs the plain
version `multi_sort_plain` (successive stable `torch.sort`s, last key
first).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ddo_tpu_torch.utils import cuda_build

#: K1's routes; each call counts as "lane_sort.<route>" (`utils/trace.py`)
ROUTES = ("regs", "perm", "merge")

#: operands one call takes (LS_MAX_OPS in csrc/lane_sort.cu)
MAX_OPERANDS = 512
#: operands a call passes in the small (3 KB) parameter struct; more pass
#: a 12 KB one (LS_SMALL_OPS)
SMALL_OPERANDS = 128
#: rows per lane the "merge" route takes (int32 positions, with room to
#: round up to a tile)
MERGE_MAX_ROWS = 1 << 30
#: the "regs" route's largest key count and padded lane length
#: (LS_NK_MAX, LS_C2_MAX: 1024 threads x 2 rows)
REGS_MAX_KEYS = 8
REGS_MAX_ROWS = 2048
#: the "perm" route's padded lane length past REGS_MAX_KEYS keys
#: (LS_PERM_C2_MAX: 512 threads x 2 rows of up to 13 words)
PERM_MAX_ROWS = 1024
#: key words a row's record carries on the "perm" and "merge" routes
#: (LS_P_MAX); the rest are read only where two rows tie on these
PREFIX_WORDS = 12
#: lanes of at most this many rows with more than REGS_MAX_KEYS keys take
#: "merge": the network pads a lane to 64 rows, a warp of two rows per
#: thread, and sorts them all (PERF.md section 6)
PERM_MIN_ROWS = 33
#: the "merge" route's least tile / window and largest tile (LS_T_MIN,
#: LS_T_MAX: 8 outputs per thread x 1024 threads)
MERGE_MIN_ROWS = 256
MERGE_MAX_TILE = 8192
#: the card's SMs (an H100 SXM's 132): the "merge" plan spreads a call
#: over at least this many blocks where it can
SMS = 132


def _args_struct(cap):
    class _SortArgs(ctypes.Structure):
        """`SortArgs<cap>` of csrc/lane_sort.cu: each operand's pointer
        and its lane and row strides (elements), handed to the kernel by
        value."""

        _fields_ = [("ptr", ctypes.c_void_p * cap),
                    ("rs", ctypes.c_int64 * cap),
                    ("cs", ctypes.c_int64 * cap)]
    return _SortArgs


_SmallArgs = _args_struct(SMALL_OPERANDS)
_LargeArgs = _args_struct(MAX_OPERANDS)


def multi_sort_plain(operands, num_keys):
    """Plain PyTorch version: a stable lexsort (stable sorts from the last
    key to the first), then one gather per operand."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key.gather(1, perm)
        idx = torch.sort(k, dim=1, stable=True).indices
        perm = idx if perm is None else perm.gather(1, idx)
    return tuple(o.gather(1, perm) for o in operands)


def _pow2_at_least(c: int, floor: int) -> int:
    return max(floor, 1 << max(0, (c - 1).bit_length()))


def _perm_smem(num_keys: int, C2: int) -> int:
    """Shared memory of the network at `num_keys` keys over C2 padded
    rows: two exchange buffers of records, then the staged key words."""
    P = min(num_keys, PREFIX_WORDS)
    return (2 * (P + 1) + num_keys - P) * C2 * 4


class MergePlan(NamedTuple):
    """How the "merge" route sorts one call: `prefix_words` key words per
    record, tiles of `tile_rows` rows sorted in shared memory, merge passes
    over windows of `window_rows` outputs per block, and each kernel's
    shared memory (bytes): the tile pass's, a merge pass's, and the
    gather pass's that follows the last merge pass when a lane of one
    operand fits a block (else 0: the last pass gathers itself)."""

    prefix_words: int
    tile_rows: int
    window_rows: int
    passes: int
    tile_smem: int
    pass_smem: int
    gather_smem: int


def merge_plan(L: int, C: int, num_keys: int) -> MergePlan:
    """The "merge" route's plan for L lanes of C rows and `num_keys` keys.
    A tile is the most rows (a power of two, MERGE_MIN_ROWS to
    MERGE_MAX_TILE) whose carried key words and two index buffers fit one
    block's shared memory, so that a lane needs few merge passes; with
    few lanes it halves, down to 2,048 rows, until the tile pass has a
    block per four SMs; and a lane that fits a tile is one tile, its rows
    rounded up to a power of two.  A merge window is the most rows whose
    records fit one block's shared memory, at most a tile, halved down to
    MERGE_MIN_ROWS until a pass has two blocks per SM.  (Chosen from
    sweeps on the card at the TSPTW, LCS, SRFLP, SOP and slab sorts:
    PERF.md.)"""
    P = min(num_keys, PREFIX_WORDS)
    # per row: a 64-bit head (two record words), the other carried words,
    # index buffers (two in a tile, one in a window) and, in a window, the
    # position
    tile_smem = lambda t: t * (8 + 4 * max(P - 2, 0) + 4)
    pass_smem = lambda s: s * (8 + 4 * (P - 1) + 2) + 8
    T = MERGE_MAX_TILE
    while T > MERGE_MIN_ROWS and tile_smem(T) > cuda_build.SMEM_PER_BLOCK:
        T //= 2
    while T > 2048 and L * -(-C // T) < SMS // 4:
        T //= 2
    T = min(T, _pow2_at_least(C, MERGE_MIN_ROWS))
    S = T
    while S > MERGE_MIN_ROWS and (pass_smem(S) > cuda_build.SMEM_PER_BLOCK
                                  or L * -(-C // S) < 2 * SMS):
        S //= 2
    passes = max(0, (-(-C // T) - 1).bit_length())
    staged = passes and 4 * C <= cuda_build.SMEM_PER_BLOCK
    return MergePlan(P, T, S, passes, tile_smem(T), pass_smem(S) if passes else 0,
                     4 * C if staged else 0)


def _fits(route: str, num_keys: int, C: int) -> bool:
    """Whether K1's `route` takes `num_keys` keys over lanes of C rows."""
    C2 = _pow2_at_least(C, 64)
    if route == "regs":
        return num_keys <= REGS_MAX_KEYS and C2 <= REGS_MAX_ROWS
    if route == "perm":
        rows = REGS_MAX_ROWS if num_keys <= REGS_MAX_KEYS else PERM_MAX_ROWS
        return C2 <= rows and _perm_smem(num_keys, C2) <= cuda_build.SMEM_PER_BLOCK
    return route == "merge" and C <= MERGE_MAX_ROWS


def lane_sort_route(num_keys: int, C: int, L: int = 1) -> str:
    """K1's route for L lanes of C rows sorted on `num_keys` keys, from
    the routes' times measured on the card in turns (chip_smoke.py phase
    2; PERF.md section 6): "regs" when the keys fit its registers
    (num_keys <= REGS_MAX_KEYS) and C, padded to a power of two, its
    threads (<= REGS_MAX_ROWS); else "perm" from PERM_MIN_ROWS rows while
    the network takes the lane (<= PERM_MAX_ROWS padded rows, its staged
    key words within shared memory); else "merge", whose tiles and
    windows `merge_plan` sizes by L.  The networks won at every lane
    count measured, one lane included, so L enters through the plan.
    Raises only past MAX_OPERANDS keys or MERGE_MAX_ROWS rows."""
    if num_keys > MAX_OPERANDS:
        raise ValueError(f"lane_sort: {num_keys} keys exceed the {MAX_OPERANDS} operands "
                         "one call takes")
    for route in ("regs", "perm", "merge"):
        if _fits(route, num_keys, C) and (route != "perm" or C >= PERM_MIN_ROWS):
            return route
    raise ValueError(f"lane_sort: C={C} rows exceed the {MERGE_MAX_ROWS} rows of the "
                     "merge route")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("lane_sort")
    for fn in (lib.lane_sort_regs, lib.lane_sort_perm):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.lane_sort_merge.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lane_sort_merge.restype = ctypes.c_int
    return lib


def multi_sort_cuda(operands, num_keys, route=None, out=None):
    """Kernel K1 on CUDA tensors (any strides), with one output allocation
    (and, on the "merge" route past one tile, one int32 [2, P + 1, L, C]
    workspace from the caching allocator); raises on what the kernel does
    not take.  `route` ("regs", "perm" or "merge") overrides
    `lane_sort_route`'s choice, so that a comparison can run several on
    one shape.  `out`, a contiguous int32 [n, L, C] tensor on the
    operands' device, takes the sorted operands in place of the output
    allocation (the compile's layer graphs read them there)."""
    n = len(operands)
    if n > MAX_OPERANDS:
        raise ValueError(f"lane_sort: {n} operands exceed the {MAX_OPERANDS} one launch takes")
    if not 1 <= num_keys <= n:
        raise ValueError(f"lane_sort: num_keys={num_keys} not in [1, {n}]")
    first = operands[0]
    L, C = first.shape
    route = route or lane_sort_route(num_keys, C, L)
    if route not in ROUTES or not _fits(route, num_keys, C):
        raise ValueError(f"lane_sort: route {route!r} does not take {num_keys} keys "
                         f"of C={C} rows")
    dev = first.device
    for o in operands:
        if not o.is_cuda or o.device != dev:
            raise ValueError("lane_sort: every operand must be on one CUDA device")
        if o.dtype != torch.int32 or o.shape != (L, C):
            raise ValueError(f"lane_sort: operands must be int32 [{L}, {C}]")
    if out is None:
        out = torch.empty((n, L, C), dtype=torch.int32, device=dev)
    elif cuda_build.check_tensors("lane_sort", [("out", out, torch.int32, (n, L, C))]) != dev:
        raise ValueError(f"lane_sort: out is on {out.device}, not on the operands' {dev}")
    if L == 0 or C == 0:
        return tuple(out.unbind(0))
    params = (_SmallArgs if n <= SMALL_OPERANDS else _LargeArgs)()
    strides = [o.stride() for o in operands]
    params.ptr[:n] = [o.data_ptr() for o in operands]
    params.rs[:n] = [rs for rs, _ in strides]
    params.cs[:n] = [cs for _, cs in strides]
    if route == "merge":
        plan = merge_plan(L, C, num_keys)
        ws = None
        if plan.passes:
            ws = torch.empty((2, plan.prefix_words + 1, L, C), dtype=torch.int32,
                             device=dev)
        fn, args = _lib().lane_sort_merge, (ws.data_ptr() if ws is not None else None, n,
                                            num_keys, L, C, plan.tile_rows, plan.window_rows)
    else:
        fn = _lib().lane_sort_regs if route == "regs" else _lib().lane_sort_perm
        args = (n, num_keys, L, C)
    cuda_build.launch("lane_sort." + route, fn, dev, ctypes.byref(params), out.data_ptr(),
                      *args)
    return tuple(out.unbind(0))


def multi_sort(operands, num_keys, out=None):
    """Engine sort: K1 for CUDA tensors (into `out` where given, see
    `multi_sort_cuda`), the plain version for CPU ones."""
    operands = tuple(operands)
    if operands[0].is_cuda:
        return multi_sort_cuda(operands, num_keys, out=out)
    if operands[0].device.type != "cpu" or out is not None:
        raise ValueError(f"multi_sort: no route for device {operands[0].device}"
                         + (" with out=" if out is not None else ""))
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
