"""Fixed-width bitset primitives over int32 words, batch-first: counterpart
of `ddo_tpu/ops/bitset.py`.

A set over `n` elements is `ceil(n / 32)` words; a batch of B sets is an
int32 [B, L] tensor.  ddo_tpu holds the words as uint32 and bit-casts them
to int32 for the dedup keys and the ranking; here they are int32
throughout (torch has no shifts or comparisons on uint32), so the keys and
their sort order are ddo_tpu's.  Two consequences of the signed type:
`>>` is arithmetic, so every right shift below is followed by a mask, and
bit 31 is built as -2**31.  torch has no population count either: `count`
is the five-step mask-and-add reduction.

Per-row element arguments (`v` int64 [B]) pick their word with
`torch.gather`, one row each.

Not ported: `reverse_bits` and `shift_right_var`, ddo_tpu's way around a
data-dependent gather (the golomb window); the port's golomb model indexes
the bits directly.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def nb_lanes(n: int) -> int:
    return max(1, (n + 31) // 32)


def full_set_np(n: int) -> np.ndarray:
    """{0..n-1} as int32 words on the host."""
    out = np.zeros(nb_lanes(n), np.uint32)
    for v in range(n):
        out[v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return out.view(np.int32)


def full_set(n: int, device=None) -> torch.Tensor:
    """{0..n-1} as words [L]."""
    return torch.as_tensor(full_set_np(n), device=device)


def empty_set(n: int, device=None) -> torch.Tensor:
    return torch.zeros(nb_lanes(n), dtype=I32, device=device)


def _bit(v):
    """The word holding only bit `v % 32`, int32 [B] (bit 31 wraps to
    -2**31, as the shift of an int32 one does)."""
    return torch.ones_like(v, dtype=I32) << (v % 32).to(I32)


def _word(s, v):
    """Word `v // 32` of every row: int32 [B]."""
    return s.gather(1, (v // 32)[:, None])[:, 0]


def singleton(n: int, v) -> torch.Tensor:
    """{v[b]} for every row: words [B, L]."""
    out = torch.zeros((v.shape[0], nb_lanes(n)), dtype=I32, device=v.device)
    return out.scatter(1, (v // 32)[:, None], _bit(v)[:, None])


def contains(s, v):
    """bool [B]: is `v[b]` in set `s[b]`."""
    return ((_word(s, v) >> (v % 32).to(I32)) & 1) > 0


def insert(s, v):
    return s.scatter(1, (v // 32)[:, None], (_word(s, v) | _bit(v))[:, None])


def remove(s, v):
    return s.scatter(1, (v // 32)[:, None], (_word(s, v) & ~_bit(v))[:, None])


def union(a, b):
    return a | b


def intersect(a, b):
    return a & b


def difference(a, b):
    return a & ~b


def count(s):
    """Set cardinality int32 [...]: the sum over the last dim of each
    word's population count (mask-and-add; each right shift is masked, so
    the sign bit of an int32 word counts once)."""
    x = s
    x = (x & 0x55555555) + ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x & 0x0F0F0F0F) + ((x >> 4) & 0x0F0F0F0F)
    x = (x & 0x00FF00FF) + ((x >> 8) & 0x00FF00FF)
    x = (x & 0x0000FFFF) + ((x >> 16) & 0x0000FFFF)
    return x.sum(dim=-1, dtype=I32)


def to_bits(s, n: int):
    """Unpack words [..., L] -> bool [..., n] membership."""
    shifts = torch.arange(32, dtype=I32, device=s.device)
    bits = (s[..., None] >> shifts) & 1  # [..., L, 32]
    return bits.reshape(tuple(s.shape[:-1]) + (s.shape[-1] * 32,))[..., :n].bool()


def from_bits(bits, n: int):
    """bool [..., n] membership -> words [..., L]."""
    lanes = nb_lanes(n)
    padded = torch.zeros(tuple(bits.shape[:-1]) + (lanes * 32,), dtype=torch.bool,
                         device=bits.device)
    padded[..., :n] = bits
    grouped = padded.reshape(tuple(bits.shape[:-1]) + (lanes, 32)).to(I32)
    shifts = torch.arange(32, dtype=I32, device=bits.device)
    # the 32 shifted bits are disjoint, so their wrapping int32 sum is their OR
    return (grouped << shifts).sum(dim=-1, dtype=I32)


def or_reduce(words, dim: int):
    """Bitwise-OR reduction along `dim` (set union over a batch of sets):
    through the bits, as torch reduces with sum/any, not with `|`."""
    L = words.shape[-1]
    dim = dim % words.dim()
    return from_bits(to_bits(words, 32 * L).any(dim=dim), 32 * L)


def and_reduce(words, dim: int):
    """Bitwise-AND reduction along `dim` (set intersection)."""
    L = words.shape[-1]
    dim = dim % words.dim()
    return from_bits(to_bits(words, 32 * L).all(dim=dim), 32 * L)


def weight_sum(s, weights_i32, n: int):
    """Sum of the members' weights int32 [...] (the MISP rough bound,
    misp/main.rs:191-193)."""
    return torch.where(to_bits(s, n), weights_i32, 0).sum(dim=-1, dtype=I32)
