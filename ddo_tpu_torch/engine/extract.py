"""Device-side row selection for the solver's per-superstep extraction:
counterpart of `ddo_tpu/engine/extract.py`.

After each superstep the solver consumes three row sets from every
compiled batch: barrier-cache threshold updates (clean.rs:534-545), exact
nodes for the global dominance store (clean.rs:697), and the cutset
(clean.rs:417-445).  The plane route (`CompiledDD.cache_batch`,
`exact_nodes_batch`, `cutset_batch`) copies whole [K, n+1, W] planes to
the host and selects rows there with numpy.  Here the selection runs on
the device and only the selected rows cross: the same row sets, unioned
over the active lanes, in the same stable (lane, layer, slot) order.

ddo_tpu compacts with a stable argsort of the mask and gathers a fixed
number M of rows, because its compiler needs static shapes.  Here
`torch.nonzero` of the flat mask gives the same rows in the same order.
The cache and dominance caps M are ddo_tpu's: dropping rows beyond them
is sound (both stores only strengthen pruning).  The cutset must be
complete, and its cap is the most rows a batch can have, so it never
truncates; `cutset_rows` still returns the true count, and the solver
falls back to the plane route if a smaller cap is ever exceeded.
"""

from __future__ import annotations

import torch

from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import sat_add

I32 = torch.int32


def _map(fn, tree):
    """`fn` over every tensor of a tree of dicts; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree) if torch.is_tensor(tree) else tree


def prefetch(tree):
    """`tree` (dicts of tensors) with every tensor as a numpy array.

    CUDA tensors are copied into pinned host buffers, every copy queued
    without blocking, then the stream is synchronized once and the
    buffers are read: a non-blocking copy into pageable memory would not
    be asynchronous, and reading a buffer before the synchronize would be
    a race.  On the CPU it is the tensors' own memory."""
    host, devices = {}, set()

    def start(t):
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
            host[id(t)] = buf.copy_(t, non_blocking=True)
            devices.add(t.device)
        return t

    _map(start, tree)
    for device in devices:
        trace.wait(torch.cuda.current_stream(device).synchronize)
    return _map(lambda t: host.get(id(t), t).numpy(), tree)


def _flat_select(sel, M):
    """(idx int64 [<=M], count): flat indices of the selected rows in
    stable (lane, layer, slot) order, cut at M; `count` is the number
    selected before the cut."""
    idx = trace.wait(torch.nonzero, sel.reshape(-1))[:, 0]
    return idx[:M], idx.shape[0]


def _take_cols(plane_cols, idx):
    """Rows `idx` (flat over lane, layer, slot) of a key-major
    [K, n1, CC, W] plane: [M, CC]."""
    K, n1, CC, W = plane_cols.shape
    return plane_cols.transpose(2, 3)[idx // (n1 * W), (idx // W) % n1, idx % W]


def cache_rows(has_theta, above, cutflag, wl_unexplored, theta, keys, actives, M):
    """(depth, key, theta, explored) rows for `Cache.update_batch`: the row
    set of `CompiledDD.cache_batch` (has_theta & above, explored = not
    (cutflag | wl_unexplored)) unioned over the active lanes."""
    K, n1, W = has_theta.shape
    sel = has_theta & above & actives[:, None, None]
    idx, count = _flat_select(sel, M)
    unexplored = (cutflag | wl_unexplored).reshape(-1)[idx]
    return dict(count=count, depths=((idx // W) % n1).to(I32),
                keys=_take_cols(keys, idx), thetas=theta.reshape(-1)[idx],
                explored=(~unexplored).to(torch.uint8))


def exact_rows(exact, mask, value, dkey, dcoord, actives, M):
    """(depth, dom_key, dom_coord, value) rows of every live exact node for
    `DominanceChecker.insert_batch` (`CompiledDD.exact_nodes_batch` unioned
    over the active lanes)."""
    K, n1, W = exact.shape
    sel = exact & mask & actives[:, None, None]
    idx, count = _flat_select(sel, M)
    return dict(count=count, depths=((idx // W) % n1).to(I32),
                dkeys=_take_cols(dkey, idx), dcoords=_take_cols(dcoord, idx),
                values=value.reshape(-1)[idx])


def cutset_rows(cutflag, marked, value, rub, value_bot, rank0, keys, best_value,
                feasible, dkey, dcoord, actives, M, with_dom):
    """Cutset rows (`CompiledDD.cutset_batch` over the active lanes):
    (lane, layer, slot, key, value, ub, score[, dom_key, dom_coord]).

    ub = min(value + rub, value + locb, the lane's best_value), as the
    host route computes it (drain_cutset, clean.rs:417-445).  `count` is
    the true row count: when it exceeds M the caller must fall back to
    the plane route (a cutset may not be truncated)."""
    K, n1, W = value.shape
    sel = cutflag & marked & (actives & feasible)[:, None, None]
    idx, count = _flat_select(sel, M)
    lanes = idx // (n1 * W)
    v = value.reshape(-1)[idx]
    ub = torch.minimum(
        torch.minimum(sat_add(v, rub.reshape(-1)[idx]),
                      sat_add(v, value_bot.reshape(-1)[idx])),
        best_value.to(I32)[lanes])
    out = dict(count=count, lanes=lanes.to(I32), layers=((idx // W) % n1).to(I32),
               slots=(idx % W).to(I32), keys=_take_cols(keys, idx), values=v, ubs=ub,
               scores=rank0.reshape(-1)[idx])
    if with_dom:
        out["dkeys"] = _take_cols(dkey, idx)
        out["dcoords"] = _take_cols(dcoord, idx)
    return out


def extract_caps(K: int, n1: int, W: int):
    """(M_cache, M_dom, M_cut) row caps for a [K, n1, W] batch.  The cache
    and dominance caps are ddo_tpu's, large enough that truncation is rare
    and small enough that the transfers stay a few MB; their truncation is
    sound (weaker pruning only).  The cutset cap is K x n1 x W, every row
    of the batch: `torch.nonzero` sizes the selection, so a cap buys
    nothing there, and ddo_tpu's 16,384 rows were below a full 128-lane
    batch at width 256."""
    N = K * n1 * W
    cap = lambda m: int(min(m, max(256, 1 << (N - 1).bit_length())))
    return cap(65536), cap(131072), N
