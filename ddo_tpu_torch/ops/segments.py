"""Segment primitives of the dedup pipeline: counterpart of
`ddo_tpu/ops/segments.py`, as native indexing.

ddo_tpu wrote every data-dependent gather and scatter as a one-hot MXU
contraction (with 12-bit splits for int32 exactness) or as a sort, because
TPU gathers with runtime indices serialize.  A GPU gathers and scatters
natively, so here each primitive is one `gather` or `scatter_`, per lane:
every tensor has a leading lane dimension K and the sorted axis second.
"""

from __future__ import annotations

import torch


def run_head_positions(head):
    """For each sorted position, the position of its run's head (-1 before
    the first head); `head` [K, C] marks the first element of each run."""
    idx = torch.arange(head.shape[1], dtype=torch.int32, device=head.device)
    return torch.cummax(torch.where(head, idx, -1), dim=1).values


def seg_broadcast_at_head(head, values):
    """Carry each run head's value down its run, for every [K, C] tensor in
    `values`; positions before the first head get position 0's value
    (callers mask invalid rows anyway)."""
    pos = run_head_positions(head).clamp(min=0).long()
    return tuple(v.gather(1, pos) for v in values)


def rev_cummin(x):
    """Suffix minimum along dim 1."""
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def take_rows(table, idx):
    """Per-lane row gather: table [K, T, ...], idx [K, M] -> [K, M, ...]."""
    lanes = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[lanes, idx.long()]


def scatter(idx, values):
    """`out[k, idx[k, i]] = values[k, i]` for a per-lane permutation `idx`
    (the inverse-permutation writes of ddo_tpu's `scatter_i32`): the indices
    are unique, so the result is deterministic."""
    return torch.empty_like(values).scatter_(1, idx.long(), values)
