"""Kernel K3: the tail of the compile's layer body, fused.

`engine/mdd.py` `_Layers` runs a layer as three segments cut at K1's two
sorts.  The last, `_seg3`, turns sort-2's order into the layer's kept,
merged and pruned nodes, its edges, the next layer and that layer's
within-layer dominance.  All of that is the engine's own bookkeeping, the
same for every model, and eagerly it is some 240 small kernels a layer.
K3 (`csrc/layer_tail.cu`) does it in three kernels, cut where the model's
hooks run, each one CTA per lane:

  * `remap` (K3a): each survivor's place in sort-2's order, which
    survivors are kept or merged, each run head's code and theta carried
    down its run (a segmented forward fill) and scattered back to
    candidate order (`Remap`);
  * `edges` (K3b): the merged node's recycling and best in-edge, every
    edge of layer i (`E[:, i]`, `eptheta`, `hic`), layer i's node planes,
    `lel` and `overflow`, and the next layer, materialized through the
    two sorts' permutations with the merged node's overrides (`Next`);
  * `dominance` (K3c): the next layer's within-layer dominance (W x W a
    lane) and the carried layer `cur`; it advances the layer index.

Between them the hooks stay PyTorch calls: the relaxation's `merge`, the
model's `pack` and, relaxed, `relax_cost` after `remap`; `take_rows` of
each state leaf, the merged state's override and the dominance columns
after `edges`.

Each part's plain version (`remap_plain`, `edges_plain`,
`dominance_plain`) is the torch code of `_seg3`, cut at the same points;
the CPU runs it.  For CUDA tensors the part launches its kernel or
raises.  A part's inputs are the named tensors of `_seg3` (`t`, the
layer's own rows `layer`, the buffers `P`, `E`, `cur`; each wrapper lists
what its kernel reads); the parts update the buffers in place and return
what the hooks read next.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ddo_tpu_torch.ops import segments as seg
from ddo_tpu_torch.utils import cuda_build
from ddo_tpu_torch.utils.num import INF, NEG_INF, argmax_first, sat_add, sat_sub

I32 = torch.int32
_M27 = (1 << 27) - 1

#: K3's parts, in launch order; each run counts as "layer_tail.<part>"
#: (`utils/trace.py`), "dominance" ending a layer's tail
PARTS = ("remap", "edges", "dominance")

#: layer i's node planes that `edges` writes from the layer's own rows
NODE_PLANES = ("val", "mask", "exact", "relaxed", "rub", "bp", "bd", "bs", "wlp", "wlth")
#: the carried layer's planes that `dominance` writes (`state` is the
#: hooks')
CARRY = ("val", "mask", "exact", "relaxed", "bp", "bd", "bs", "ebp", "wlp", "wlth")
_BOOLS = {"mask", "exact", "relaxed", "bs", "wlp", "ebp"}
_NEXT_BOOLS = {"valid", "exact", "relaxed", "bs", "fresh"}


class Remap(NamedTuple):
    """`remap`'s output, [K, C] each: `rank_of` and `kept` in sort-1's
    order, the others in candidate order."""
    rank_of: torch.Tensor  # int32: the position's place in sort-2's order
    kept: torch.Tensor  # bool
    e_code: torch.Tensor  # int32: rank | kept<<27 | merged<<28 | pruned<<29 | pci<<30
    cand_ptheta: torch.Tensor  # int32: the run head's filter theta
    f_mmask: torch.Tensor  # bool: the candidate merges into the merged node


class Next(NamedTuple):
    """`edges`' output, the next layer before within-layer dominance,
    [K, W] each."""
    fidx: torch.Tensor  # int32: the candidate each slot takes its state from
    valid: torch.Tensor  # bool
    val: torch.Tensor  # int32
    exact: torch.Tensor  # bool
    relaxed: torch.Tensor  # bool
    bp: torch.Tensor  # int32
    bd: torch.Tensor  # int32
    bs: torch.Tensor  # bool
    fresh: torch.Tensor  # bool: the slot takes the merged state


def _limit(cap, need_relax, need_restrict, C):
    """The rank below which a survivor is kept, per lane."""
    return torch.where(need_relax, cap - 1, torch.where(need_restrict, cap, C))


# ------------------------------------------------------------ plain versions
def remap_plain(t):
    """K3a's plain version: `t` holds sort-2's `neg_order` (its last
    operand, minus each sorted position's sort-1 position) and seg2's
    `surv`, `head`, `perm`, `pruned`, `pci`, `ptheta`, `cap`,
    `need_relax`, `need_restrict`."""
    surv, need_relax = t["surv"], t["need_relax"]
    K, C = surv.shape
    idxs = torch.arange(C, dtype=I32, device=surv.device)
    rank_of = seg.scatter(-t["neg_order"], idxs.expand(K, C))
    limit = _limit(t["cap"], need_relax, t["need_restrict"], C)
    kept = surv & (rank_of < limit[:, None])
    merge_mask = surv & ~kept & need_relax[:, None]
    # every candidate takes its run head's code
    slot_code = (rank_of + (kept.to(I32) << 27) + (merge_mask.to(I32) << 28)
                 + (t["pruned"].to(I32) << 29) + (t["pci"].to(I32) << 30))
    code_s, ptheta_s = seg.seg_broadcast_at_head(t["head"], (slot_code, t["ptheta"]))
    perm = t["perm"]
    return Remap(rank_of, kept, seg.scatter(perm, code_s), seg.scatter(perm, ptheta_s),
                 seg.scatter(perm, merge_mask))


def edges_plain(i, t, a, merged_key, rcost, layer, P, E, lel, overflow):
    """K3b's plain version: layer i's edges and node planes, and the next
    layer.  `i` the int64 0-d layer index; `t` also holds sort-2's
    `so_key` and `so_negval` (its first two operands), `kv`, `val_s`,
    `slot_exact`, `U`, the candidates' `f_valid`, `f_cost`, `f_dval` and,
    with long arcs, `skip_s` and `f_skip`; `a` is `remap`'s output;
    `merged_key` int32 [K, Kk]; `rcost` the relaxed cost of every
    candidate (None unless relaxed); `layer` the layer's own rows by
    plane name (`NODE_PLANES`).  Writes `P[name][:, i]` for
    `NODE_PLANES`, `hic` and (where `P["eptheta"]` is not None: filtering)
    `eptheta`, `E[name][:, i]`, `lel` and `overflow`."""
    i1 = i.view(1)
    rank_of, kept, e_code = a.rank_of, a.kept, a.e_code
    K, C = kept.shape
    W = layer["val"].shape[1]
    D, n = C // W, P["val"].shape[1] - 1
    dev = kept.device
    idxs = torch.arange(C, dtype=I32, device=dev)
    q = torch.arange(W, dtype=I32, device=dev)
    need_relax, need_restrict, cap, U = t["need_relax"], t["need_restrict"], t["cap"], t["U"]
    f_valid, f_cost, f_dval = t["f_valid"], t["f_cost"], t["f_dval"]
    long_arcs = t.get("skip_s") is not None
    squashed = need_relax | need_restrict
    limit = _limit(cap, need_relax, need_restrict, C)
    order2 = -t["neg_order"]

    # the merged node recycles a kept node of its own key
    eq_kept = kept & (t["kv"] == merged_key[:, None, :]).all(dim=2)
    recycled = eq_kept.any(dim=1) & need_relax
    recycled_slot = argmax_first(eq_kept.to(I32))[:, None]
    merged_pos = torch.where(recycled, rank_of.gather(1, recycled_slot)[:, 0], limit)

    # recycle/save: when the merged state equals a kept node, the saved
    # slot (rank == limit) stays a kept node (clean.rs:830,868-875)
    e_saved = recycled[:, None] & ((e_code & _M27) == limit[:, None]) \
        & ((e_code & (1 << 28)) != 0)
    e_kept = f_valid & (((e_code & (1 << 27)) != 0) | e_saved)
    e_merge = f_valid & ((e_code & (1 << 28)) != 0) & need_relax[:, None] & ~e_saved
    e_pruned = f_valid & ((e_code & (1 << 29)) != 0)
    e_pci = f_valid & ((e_code & (1 << 30)) != 0)
    e_cost = f_cost if rcost is None else torch.where(e_merge, rcost, f_cost)
    e_child = torch.where(e_kept, e_code & _M27, torch.where(e_merge, merged_pos[:, None], -1))
    e_valid = f_valid & (e_child >= 0)

    # theta of filter-pruned children propagates to parents
    # (clean.rs:502,522-528): per-parent min of (theta - cost)
    if P.get("eptheta") is not None:
        ep = torch.where(e_pruned, sat_sub(a.cand_ptheta, f_cost), INF)
        put(P["eptheta"], i1, ep.view(K, W, D).amin(dim=2))

    # merged node aggregates (append_edge_to!, clean.rs:199-219)
    c_val = layer["val"]
    m_edge_val = torch.where(e_merge, sat_add(c_val.repeat_interleave(D, dim=1), e_cost),
                             NEG_INF)
    m_val = m_edge_val.amax(dim=1)
    m_is_best = e_merge & (m_edge_val == m_val[:, None])
    m_best_flat = torch.where(m_is_best, idxs, -1).amax(dim=1)
    has_medge = m_best_flat >= 0
    m_best = m_best_flat.clamp(0, C - 1).long()[:, None]
    m_bp = torch.where(has_medge, m_best[:, 0].to(I32) // D, -1)
    m_bd = torch.where(has_medge, f_dval.gather(1, m_best)[:, 0], 0)

    # materialize the next layer: the first W ranking-sorted slots,
    # through the composition of the two sort permutations
    width_used = torch.where(squashed, torch.where(need_relax, limit + 1, cap),
                             torch.clamp(U, max=W))
    overflow |= (U > W) & ~squashed
    so_valid = t["so_key"][:, :W] == 0
    order2_W = order2[:, :W].long()
    fidx = t["perm"].gather(1, order2_W)
    q_valid = (q < width_used[:, None]) & so_valid
    nl_val = -t["so_negval"][:, :W]
    nl_exact = t["slot_exact"].gather(1, order2_W)
    nl_bp = torch.where(so_valid, fidx // D, -1)
    nl_bd = f_dval.gather(1, fidx.long())
    # a node whose best in-edge is a long (skip) arc
    nl_bs = t["skip_s"].gather(1, order2_W) if long_arcs \
        else torch.zeros((K, W), dtype=torch.bool, device=dev)

    # overrides for the merged node
    is_mpos = need_relax[:, None] & (q == merged_pos[:, None])
    rec_val = t["val_s"].gather(1, recycled_slot)[:, 0]
    mv_new = torch.where(recycled[:, None], torch.maximum(nl_val, m_val[:, None]),
                         m_val[:, None])
    take_medge = has_medge & torch.where(recycled, m_val >= rec_val, True)
    nl_val = torch.where(is_mpos, mv_new, nl_val)
    use_m = is_mpos & take_medge[:, None]
    nl_bp = torch.where(use_m, m_bp[:, None], nl_bp)
    nl_bd = torch.where(use_m, m_bd[:, None], nl_bd)
    if long_arcs:
        m_bs = has_medge & t["f_skip"].gather(1, m_best)[:, 0]
        nl_bs = torch.where(use_m, m_bs[:, None], nl_bs)
    # the merged node is never exact, recycled or not (node_flags.rs:88-90)
    nl_exact = nl_exact & ~is_mpos
    q_valid = q_valid | is_mpos
    nl_exact = nl_exact & q_valid
    nl_relaxed = is_mpos & q_valid

    # frontier-cutset ingredient (clean.rs:586-606): an inexact child;
    # rows that within-layer dominance prunes later are not inexact
    ch_inexact = e_valid & ~nl_exact.gather(1, e_child.clamp(0, W - 1).long())
    put(P["hic"], i1, (ch_inexact | e_pci).view(K, W, D).any(dim=2))

    # LEL (clean.rs:796-800): the layer before the first squashed one
    lel.copy_(torch.where(squashed & (lel == n + 1), i.to(I32), lel))

    for name in NODE_PLANES:
        put(P[name], i1, layer[name])
    for name, val in (("child", e_child), ("cost", e_cost), ("valid", e_valid)):
        put(E[name], i1, val)
    return Next(fidx, q_valid, nl_val, nl_exact, nl_relaxed, nl_bp, nl_bd, nl_bs,
                is_mpos & ~recycled[:, None])


def dominance_plain(i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur):
    """K3c's plain version: within-layer dominance of the next layer
    (clean.rs:689-708, the layer-local part; `w_dkey` [K, W, KK] and
    `w_dcoord` [K, W, CC] its columns, None where it is off), then the
    carried layer `cur` (`CARRY`), and i advanced.  Dominated exact rows
    stay in the buffer masked-invalid, carrying their threshold as
    theta."""
    K, W = nxt.valid.shape
    q_valid, nl_val, nl_exact, nl_relaxed, nl_bp = (nxt.valid, nxt.val, nxt.exact,
                                                    nxt.relaxed, nxt.bp)
    wl_pruned = torch.zeros((K, W), dtype=torch.bool, device=q_valid.device)
    wl_ptheta = torch.full((K, W), INF, dtype=I32, device=q_valid.device)
    if w_dkey is not None:
        nv = torch.where(q_valid, nl_val, NEG_INF)
        cand = q_valid & nl_exact
        km_ij = (w_dkey[:, :, None] == w_dkey[:, None]).all(dim=3)
        ge_ij = (w_dcoord[:, :, None] >= w_dcoord[:, None]).all(dim=3)
        eq_ij = (w_dcoord[:, :, None] == w_dcoord[:, None]).all(dim=3)
        both = cand[:, :, None] & cand[:, None, :]
        vi, vj = nv[:, :, None], nv[:, None, :]
        if use_value:  # [k, i, j]: i strictly dominates j
            dom_ij = both & km_ij & ge_ij & (vi >= vj) & ~(eq_ij & (vi == vj))
        else:
            dom_ij = both & km_ij & ge_ij & ~eq_ij
        wl_pruned = dom_ij.any(dim=1)
        if use_value:
            # thresholds from MAXIMAL dominators only
            maximal = cand & ~wl_pruned
            contrib = torch.where(eq_ij, vi - 1, vi)
            wl_thr = torch.where(dom_ij & maximal[:, :, None], contrib, INF).amin(dim=1)
            wl_ptheta = torch.where(wl_pruned, wl_thr, INF)

    q_valid = q_valid & ~wl_pruned
    nl_exact = nl_exact & q_valid
    nl_relaxed = nl_relaxed & q_valid
    # exact-best-path flag, incrementally (clean.rs:643-655)
    par_ebp = c_ebp.gather(1, nl_bp.clamp(0, W - 1).long()) & (nl_bp >= 0)
    nl_ebp = (nl_exact | (~nl_relaxed & par_ebp)) & q_valid
    out = dict(val=torch.where(q_valid, nl_val, NEG_INF), mask=q_valid, exact=nl_exact,
               relaxed=nl_relaxed, bp=nl_bp, bd=nxt.bd, bs=nxt.bs & q_valid, ebp=nl_ebp,
               wlp=wl_pruned, wlth=wl_ptheta)
    for name in CARRY:
        cur[name].copy_(out[name])
    i.add_(1)


def put(plane, i1, value):
    """plane[:, i] = value for a [K, m, ...] plane, `i1` the int64 [1]
    index on its device (no host read of the index)."""
    plane.index_copy_(1, i1, value.to(plane.dtype).unsqueeze(1))


# ----------------------------------------------------------------- the parts
def remap(t):
    """K3a for CUDA tensors, its plain version for CPU ones."""
    if t["surv"].is_cuda:
        return remap_cuda(t)
    return remap_plain(t)


def edges(i, t, a, merged_key, rcost, layer, P, E, lel, overflow):
    """K3b for CUDA tensors, its plain version for CPU ones."""
    if i.is_cuda:
        return edges_cuda(i, t, a, merged_key, rcost, layer, P, E, lel, overflow)
    return edges_plain(i, t, a, merged_key, rcost, layer, P, E, lel, overflow)


def dominance(i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur):
    """K3c for CUDA tensors, its plain version for CPU ones."""
    if i.is_cuda:
        return dominance_cuda(i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur)
    return dominance_plain(i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur)


# ------------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("layer_tail")
    for p in PARTS:
        fn = getattr(lib, "layer_tail_" + p)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _pointers(args, ints):
    """A part's arguments as ctypes arrays: the pointers of `args` (0 for
    None) and the ints `ints`."""
    return ((ctypes.c_int64 * len(args))(*[0 if x is None else x.data_ptr()
                                           for _, x, _, _ in args]),
            (ctypes.c_int * len(ints))(*ints))


def _sizes(t):
    K, C = t["surv"].shape
    if C >= 1 << 27:
        raise ValueError(f"layer_tail: C={C} candidates exceed the 27 bits of an edge code")
    return K, C


def remap_cuda(t):
    """K3a on CUDA tensors; raises on what the kernel does not take."""
    K, C = _sizes(t)
    i32, b = torch.int32, torch.bool
    ins = [(x, t.get(x), dtype, shape) for x, dtype, shape in
           [("neg_order", i32, (K, C)), ("surv", b, (K, C)), ("head", b, (K, C)),
            ("perm", i32, (K, C)), ("pruned", b, (K, C)), ("pci", b, (K, C)),
            ("ptheta", i32, (K, C)), ("cap", i32, (K,)), ("need_relax", b, (K,)),
            ("need_restrict", b, (K,))]]
    dev = cuda_build.check_tensors("layer_tail.remap", ins)
    out = Remap(torch.empty((K, C), dtype=i32, device=dev),
                torch.empty((K, C), dtype=b, device=dev),
                torch.empty((K, C), dtype=i32, device=dev),
                torch.empty((K, C), dtype=i32, device=dev),
                torch.empty((K, C), dtype=b, device=dev))
    args = ins + [(name, x, x.dtype, x.shape) for name, x in out._asdict().items()]
    cuda_build.launch("layer_tail.remap", _lib().layer_tail_remap, dev,
                      *_pointers(args, [K, C]))
    return out


def edges_cuda(i, t, a, merged_key, rcost, layer, P, E, lel, overflow):
    """K3b on CUDA tensors; raises on what the kernel does not take."""
    K, C = _sizes(t)
    W = layer["val"].shape[1]
    if W < 1 or C % W:
        raise ValueError(f"layer_tail.edges: C={C} candidates are not a multiple of W={W}")
    n = P["val"].shape[1] - 1
    Kk = t["kv"].shape[2] if t.get("kv") is not None and t["kv"].dim() == 3 else -1
    i32, b = torch.int32, torch.bool
    kc, kw, pl, ed = (K, C), (K, W), (K, n + 1, W), (K, n, C)
    ins = [("i", i, torch.int64, ())]
    ins += [(x, t.get(x), dtype, shape) for x, dtype, shape in
            [("neg_order", i32, kc), ("so_key", i32, kc), ("so_negval", i32, kc),
             ("kv", i32, (K, C, Kk)), ("cap", i32, (K,)), ("U", i32, (K,)),
             ("need_relax", b, (K,)), ("need_restrict", b, (K,)), ("perm", i32, kc),
             ("val_s", i32, kc), ("slot_exact", b, kc), ("skip_s", b, kc),
             ("f_valid", b, kc), ("f_cost", i32, kc), ("f_dval", i32, kc),
             ("f_skip", b, kc)]]
    ins += [("rank_of", a.rank_of, i32, kc), ("kept", a.kept, b, kc),
            ("e_code", a.e_code, i32, kc), ("cand_ptheta", a.cand_ptheta, i32, kc),
            ("merged_key", merged_key, i32, (K, Kk)), ("rcost", rcost, i32, kc)]
    ins += [("layer." + x, layer.get(x), b if x in _BOOLS else i32, kw) for x in NODE_PLANES]
    bufs = [("P." + x, P.get(x), b if x in _BOOLS else i32, pl) for x in NODE_PLANES]
    bufs += [("P.hic", P.get("hic"), b, (K, n, W)), ("P.eptheta", P.get("eptheta"), i32, (K, n, W)),
             ("E.child", E.get("child"), i32, ed), ("E.cost", E.get("cost"), i32, ed),
             ("E.valid", E.get("valid"), b, ed), ("lel", lel, i32, (K,)),
             ("overflow", overflow, b, (K,))]
    # no rcost: not relaxed; no eptheta: no filtering; no skip_s: no long arcs
    optional = {"rcost", "P.eptheta"}
    if t.get("skip_s") is None:
        optional |= {"skip_s", "f_skip"}
    dev = cuda_build.check_tensors("layer_tail.edges", ins + bufs, optional)
    out = Next(*(torch.empty(kw, dtype=dtype, device=dev)
                 for dtype in (i32, b, i32, b, b, i32, i32, b, b)))
    args = ins + bufs + [(name, x, x.dtype, x.shape) for name, x in out._asdict().items()]
    cuda_build.launch("layer_tail.edges", _lib().layer_tail_edges, dev,
                      *_pointers(args, [K, C, W, n, Kk]))
    return out


def dominance_cuda(i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur):
    """K3c on CUDA tensors; raises on what the kernel does not take."""
    K, W = nxt.valid.shape
    i32, b = torch.int32, torch.bool
    if (w_dkey is None) != (w_dcoord is None):
        raise ValueError("layer_tail.dominance: w_dkey and w_dcoord come together")
    KK = w_dkey.shape[2] if w_dkey is not None and w_dkey.dim() == 3 else 0
    CC = w_dcoord.shape[2] if w_dcoord is not None and w_dcoord.dim() == 3 else 0
    ins = [("i", i, torch.int64, ())]
    ins += [("nxt." + name, getattr(nxt, name), b if name in _NEXT_BOOLS else i32, (K, W))
            for name in Next._fields]
    ins += [("w_dkey", w_dkey, i32, (K, W, KK)), ("w_dcoord", w_dcoord, i32, (K, W, CC)),
            ("c_ebp", c_ebp, b, (K, W))]
    bufs = [("cur." + x, cur.get(x), b if x in _BOOLS else i32, (K, W)) for x in CARRY]
    dev = cuda_build.check_tensors("layer_tail.dominance", ins + bufs,
                                   {"w_dkey", "w_dcoord"})
    cuda_build.launch("layer_tail.dominance", _lib().layer_tail_dominance, dev,
                      *_pointers(ins + bufs, [K, W, KK, CC, int(bool(use_value)),
                                              int(w_dkey is not None)]))
