"""The yardstick of the kernels' roofline shares: an H100's peaks and the
least time each kernel's call could take.

Frozen copies of `chip_smoke.py`'s `bound`, `sort_bound` and
`backward_bound` (commit b93b248), so that the program cannot move the
yardstick it is measured by.  The HBM rate is NVIDIA's data sheet (H100
SXM); the int32 rate is derived, not published: 64 INT32 lanes per SM x
132 SMs x 1.98 GHz, the boost clock behind the data sheet's 67 TFLOP/s of
float32.  All times are in seconds.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(seconds, what binds): the larger of the bytes' time at the memory
    rate and the int32 operations' time at the int32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sort_bound(L: int, C: int, num_keys: int, n_ops: int) -> float:
    """K1 (`ops/sort.py` -> `csrc/lane_sort.cu`), the same for every route:
    each of the n_ops int32 [L, C] operands read once and written once, and
    a comparison sort's C2 log2(C2) compares per lane (C2 = C padded to a
    power of two), each over the num_keys key words and the row position at
    3 int32 operations per word (two loads' compare and a select)."""
    C2 = 1 << max(1, (C - 1).bit_length())
    compares = L * C2 * (C2.bit_length() - 1)
    return bound(8 * n_ops * L * C, compares * 3 * (num_keys + 1))[0]


def backward_bound(K: int, n: int, W: int, D: int) -> float:
    """K2 (`engine/backward.py` -> `csrc/backward.cu`) over K lanes of n
    layers of W slots and D out-edges per slot: its 11 input planes (9 B
    per edge, 20 B per node), 4 output planes (10 B per node) and the
    carries' initial rows, each byte once; 14 int32 operations per edge and
    30 per node (the kernel's `sweep_layer`)."""
    C = W * D
    return bound(K * n * (9 * C + 30 * W) + K * (8 * W + 4), K * n * (14 * C + 30 * W))[0]
