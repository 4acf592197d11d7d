"""The dense, batched MDD compilation engine: counterpart of
`ddo_tpu/engine/mdd.py` (reference: the vector MDD of
ddo/src/implementation/mdd/clean.rs).

One call compiles K diagrams at once, one per root subproblem (a "lane"):

  * a layer is a [K, W] structure-of-arrays slab (validity-masked), and
    every layer is written into preallocated [K, n+1, W] planes for the
    bottom-up pass and the host queries;
  * expansion calls the model's batch-first `step` on all K*W rows and the
    D domain slots at once (replaces for_each_in_domain + transition,
    clean.rs:360-370);
  * duplicate-state detection = canonical key packing + one per-lane
    multi-key sort (kernel K1 on the GPU) + run heads (replaces the
    FxHashMap, clean.rs:143,738);
  * restriction/relaxation = a second per-lane sort by (value, ranking)
    with a per-lane effective width (clean.rs:802-876);
  * edges are stored outbound, flat [K, n, W*D] (child slot, cost, valid),
    and the local bounds (clean.rs:448-475) and thresholds
    (clean.rs:478-532) come from one fused backward sweep (kernel K2 on
    the GPU, engine/backward.py);
  * exactness/cutset bookkeeping (NodeFlags, node_flags.rs:48-63) is
    parallel boolean planes.

The layer loop is a Python loop over layers; every per-lane decision in it
(is this the root layer, which variable to branch on, does the layer
overflow its width, relax or not) stays a [K] device tensor combined with
`torch.where`, so a compile makes no host round trip.  With a dynamic
order (`var_order()` is None) each lane picks its own variable per layer
through `next_variable`; when the model overrides `is_impacted_by` the
engine runs in long-arc mode (pooled.rs:608-680): a node the branched
variable does not impact crosses the layer through one zero-cost identity
arc (domain slot 0) flagged `bs`, whose decision no path records.  The
loop starts at the batch's minimum root depth: earlier layers keep the
planes' neutral fill (val=-inf, rub/wlth/eptheta=+inf, bp/child=-1, masks
False).

Semantics, tie-breaks and documented divergences are ddo_tpu's, so every
plane compares bit for bit (see ddo_tpu/engine/mdd.py's module notes):
the unique `-idx` final key in both sorts, the max flat index for a merged
node's best in-edge, argmax taking the first index, and the recycled-merge
divergence (a recycled node keeps only its original in-edge).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ddo_tpu_torch.core.problem import ModelBundle, Problem
from ddo_tpu_torch.core.types import CompilationType, CutsetType, SubProblem, host_batch
from ddo_tpu_torch.engine import backward as bwd
from ddo_tpu_torch.engine import extract
from ddo_tpu_torch.ops import segments as seg
from ddo_tpu_torch.ops import sort as sort_ops
from ddo_tpu_torch.utils.num import INF, NEG_INF, argmax_first, sat_add, sat_sub

I32 = torch.int32
_M27 = (1 << 27) - 1


@dataclasses.dataclass(frozen=True)
class DDSpec:
    """Static configuration of one compilation."""

    bundle: ModelBundle
    width: int  # W: layer buffer width
    comp_type: CompilationType
    cutset_type: CutsetType
    #: optional Dominance whose hooks (key_cols/coord_cols) drive
    #: in-compilation dominance filtering (clean.rs:689-708)
    dominance: Any = None


# --------------------------------------------------------------- state trees
def tmap(fn, *trees):
    """Apply `fn` leafwise to states that are dicts of tensors or one tensor."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _flat(tree, nd):
    """Merge the leading `nd` dims of every leaf into one batch dim."""
    return tmap(lambda x: x.reshape((-1,) + tuple(x.shape[nd:])), tree)


def _unflat(tree, lead):
    return tmap(lambda x: x.reshape(tuple(lead) + tuple(x.shape[1:])), tree)


def _bcast(mask, x):
    """View a [K, W] mask so it broadcasts against a [K, W, ...] leaf."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))


def _write_layer(planes, i, values):
    """planes[:, i] = values for a state tree of [K, n+1, ...] planes."""
    if isinstance(planes, dict):
        for k in planes:
            planes[k][:, i] = values[k]
    else:
        planes[:, i] = values


def _sort(ops, num_keys):
    # K1 reads strided operands: no copy beyond the int32 casts
    return sort_ops.multi_sort([o.to(I32) for o in ops], num_keys)


def _cols(fn, states, lead):
    """A batch-first hook over [*lead, ...] states -> int32 [*lead, k]."""
    out = fn(_flat(states, len(lead)))
    return out.to(I32).reshape(tuple(lead) + (out.shape[-1],))


def has_long_arcs(problem) -> bool:
    """The engine is in long-arc mode exactly when the model overrides
    `is_impacted_by`."""
    return type(problem).is_impacted_by is not Problem.is_impacted_by


# ----------------------------------------------------------------- compile
class CutoffInterrupt(Exception):
    """Raised by a chunked compilation when the Cutoff fires mid-compile
    (`Err(Reason::CutoffOccurred)` from inside `_compile`, clean.rs:352-354)."""


def compile_lanes(spec: DDSpec, datas, order, root_states, root_values,
                  root_depths, best_lb, eff_width, root_path_sets,
                  cache_tab=None, dom_tab=None, cutoff=None, chunk_layers=None,
                  start=0):
    """Compile K diagrams: the forward layer loop, then `finalize`.

    `root_states` [K, ...], `root_values` / `root_depths` / `best_lb` /
    `eff_width` int32 [K] tensors on the compile device, `order` the
    [n] branching order (host array or device tensor) or None for a
    dynamic one, `root_path_sets`
    bool [K, n] the variables each root's path has decided (a dynamic
    order's starting `assigned`), `start` the first layer to run (at most
    every lane's root depth; `var_of` stays 0 above it under a dynamic
    order).  Filter tables (clean.rs:689-726) are dicts of tensors shared
    by every lane:
      cache_tab = {keys [n+1,T,K] i32, vals [n+1,T] i32, valid [n+1,T] bool}
      dom_tab   = {keys [n+1,T,KK], coords [n+1,T,CC], vals [n+1,T],
                   valid [n+1,T]}
    With `chunk_layers` and a `cutoff`, the cutoff is polled every
    `chunk_layers` layers and `CutoffInterrupt` raised when it fires.
    Returns the dict of planes and per-lane scalars of ddo_tpu's
    `finalize_kernel` (ddo_tpu/engine/mdd.py:1044-1060)."""
    problem = spec.bundle.problem
    rlx = spec.bundle.relaxation
    ranking = spec.bundle.ranking
    pdata, rdata, kdata = datas
    dom = spec.dominance
    comp = spec.comp_type
    device = root_values.device
    K = root_values.shape[0]
    n, W, D = problem.nb_variables, spec.width, problem.domain_size
    C = W * D
    use_dom = dom is not None and dom.key_cols(root_states) is not None
    use_dom_snap = use_dom and dom_tab is not None
    filtering = cache_tab is not None or use_dom_snap
    long_arcs = has_long_arcs(problem)
    dynamic_order = order is None

    eff_width = torch.clamp(eff_width, 1, W)
    lel = torch.full((K,), n + 1, dtype=I32, device=device)
    expanded = torch.zeros((K,), dtype=I32, device=device)
    overflow = torch.zeros((K,), dtype=torch.bool, device=device)
    idxs = torch.arange(C, dtype=I32, device=device)
    neg_idxs = (-idxs).expand(K, C)
    q = torch.arange(W, dtype=I32, device=device)
    slot0 = torch.arange(D, device=device) == 0
    if dynamic_order:
        var_of = torch.zeros((K, n), dtype=I32, device=device)
        assigned = root_path_sets
    else:
        order_t = (order.to(device=device, dtype=torch.long) if torch.is_tensor(order)
                   else torch.as_tensor(np.asarray(order), dtype=torch.long, device=device))
        var_of = order_t.to(I32).expand(K, n)

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=device)

    false = lambda shape: torch.zeros(shape, dtype=torch.bool, device=device)

    # --- the root layer as a [K, W] row (slot 0) --------------------------
    r_state = tmap(lambda x: x[:, None].expand((K, W) + tuple(x.shape[1:])),
                   root_states)
    r_val = full((K, W), NEG_INF)
    r_val[:, 0] = root_values
    r_mask = false((K, W))
    r_mask[:, 0] = True
    cur = dict(
        state=tmap(torch.zeros_like, r_state), val=full((K, W), NEG_INF),
        mask=false((K, W)), exact=false((K, W)), relaxed=false((K, W)),
        bp=full((K, W), -1), bd=full((K, W), 0), bs=false((K, W)),
        ebp=false((K, W)), wlp=false((K, W)), wlth=full((K, W), INF),
    )

    # --- output planes, neutral below the first layer run -----------------
    N1 = (K, n + 1, W)
    P = dict(
        state=tmap(lambda x: torch.zeros((K, n + 1) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=device), r_state),
        val=full(N1, NEG_INF), mask=false(N1), exact=false(N1),
        relaxed=false(N1), rub=full(N1, INF), bp=full(N1, -1), bd=full(N1, 0),
        bs=false(N1), wlp=false(N1), wlth=full(N1, INF),
        eptheta=full((K, n, W), INF), hic=false((K, n, W)),
    )
    E = dict(child=full((K, n, C), -1), cost=full((K, n, C), 0),
             valid=false((K, n, C)))

    def poll(i):
        if device.type == "cuda" and i > start:
            torch.cuda.synchronize(device)  # bound the device work queued
        if cutoff.must_stop():
            raise CutoffInterrupt()

    chunked = bool(chunk_layers) and cutoff is not None and n > chunk_layers
    for i in range(start, n):
        if chunked and (i - start) % chunk_layers == 0:
            poll(i)
        is_last = i == n - 1

        # root layer materializes at depth `root_depth` (clean.rs:383-405)
        is_root = (root_depths == i)[:, None]  # [K, 1]
        c_state = tmap(lambda r, c: torch.where(_bcast(is_root, c), r, c),
                       r_state, cur["state"])
        c_val = torch.where(is_root, r_val, cur["val"])
        c_mask = torch.where(is_root, r_mask, cur["mask"])
        c_exact = torch.where(is_root, r_mask, cur["exact"])
        c_relaxed = cur["relaxed"] & ~is_root
        c_bp = torch.where(is_root, -1, cur["bp"])
        c_bd = torch.where(is_root, 0, cur["bd"])
        c_bs = cur["bs"] & ~is_root
        c_ebp = torch.where(is_root, r_mask, cur["ebp"])
        c_wlp = cur["wlp"] & ~is_root
        c_wlth = torch.where(is_root, INF, cur["wlth"])
        flat_state = _flat(c_state, 2)

        # the branched variable, one per lane: int64 [K]
        if dynamic_order:
            var = problem.next_variable(pdata, i, c_state, c_mask, assigned).long()
            var_of[:, i] = var
            col = var[:, None]
            assigned = assigned.scatter(
                1, col, assigned.gather(1, col) | c_mask.any(dim=1, keepdim=True))
        else:
            var = order_t[i].expand(K)
        var_b = var.repeat_interleave(W)

        # --- RUB pruning (clean.rs:360-365) --------------------------------
        rub = torch.where(c_mask, rlx.rub(rdata, flat_state, i).view(K, W), INF)
        expand_ok = c_mask & (sat_add(c_val, rub) > best_lb[:, None])
        if long_arcs:
            # only the impacted rows really branch here
            imp = problem.is_impacted_by(pdata, flat_state, var_b)  # [K*W]
            expanded += (expand_ok & imp.view(K, W)).sum(dim=1, dtype=I32)
        else:
            expanded += expand_ok.sum(dim=1, dtype=I32)

        # --- expansion of K*W rows x D slots --------------------------------
        nstate, cost, dval, valid = problem.step(pdata, flat_state, var_b, i)
        if long_arcs:
            # an unimpacted row: one identity candidate at domain slot 0
            keep = imp[:, None]  # [K*W, 1]
            valid = torch.where(keep, valid, slot0)
            nstate = tmap(lambda real, cur: torch.where(
                _bcast(keep, real), real, cur[:, None]), nstate, flat_state)
            cost = torch.where(keep, cost, 0)
            f_skip = (~keep).expand(K * W, D).reshape(K, C)
        # flatten candidates: append order = (parent slot, domain slot)
        f_valid = (valid & expand_ok.reshape(K * W, 1)).reshape(K, C)
        f_cost = cost.to(I32).reshape(K, C)
        f_val = sat_add(c_val.repeat_interleave(D, dim=1), f_cost)
        f_dval = dval.to(I32).reshape(K, C)
        f_state = _unflat(_flat(nstate, 2), (K, C))
        f_pexact = c_exact.repeat_interleave(D, dim=1)

        # --- dedup: sort by (valid, key, -value, -append idx) so that the
        # head of each key-run is the best in-edge: max value, ties to the
        # last appended edge (the `>=` rule of clean.rs:215-218)
        f_keys = _cols(problem.pack, f_state, (K, C))  # [K, C, Kk]
        Kk = f_keys.shape[2]
        key_ops = [(~f_valid).to(I32)] + [f_keys[:, :, k] for k in range(Kk)] \
            + [-f_val, neg_idxs]
        f_rank = _cols(lambda s: ranking.score(kdata, s), f_state, (K, C))
        R = f_rank.shape[2]
        pay = [f_dval, f_pexact.to(I32)] + ([f_skip.to(I32)] if long_arcs else []) \
            + [f_rank[:, :, r] for r in range(R)]
        if use_dom:
            f_dkey = _cols(dom.key_cols, f_state, (K, C))
            f_dcoord = _cols(dom.coord_cols, f_state, (K, C))
            KK, CC = f_dkey.shape[2], f_dcoord.shape[2]
            pay += [f_dkey[:, :, k] for k in range(KK)]
            pay += [f_dcoord[:, :, k] for k in range(CC)]
        s1 = _sort(key_ops + pay, len(key_ops))
        kv = torch.stack(s1[1 : 1 + Kk], dim=2)
        perm = -s1[2 + Kk]
        valid_s = s1[0] == 0
        val_s = torch.where(valid_s, -s1[1 + Kk], NEG_INF)
        o = 3 + Kk
        pexact_s = s1[o + 1].bool()
        o += 2
        if long_arcs:
            skip_s = s1[o].bool()
            o += 1
        s_rank = torch.stack(s1[o : o + R], dim=2)
        o += R
        if use_dom:
            s_dkey = torch.stack(s1[o : o + KK], dim=2) if KK else f_dkey
            s_dcoord = torch.stack(s1[o + KK : o + KK + CC], dim=2) if CC else f_dcoord

        first = torch.ones((K, C), dtype=torch.bool, device=device)
        first[:, 1:] = (kv[:, 1:] != kv[:, :-1]).any(dim=2)
        head = valid_s & first
        # exactness = AND over the run's parents: no inexact member
        # between a head and its run end
        nx = seg.rev_cummin(torch.where(head, idxs, C))
        run_end = torch.cat([nx[:, 1:], full((K, 1), C)], dim=1)
        inexact = valid_s & ~pexact_s
        slot_exact = seg.rev_cummin(torch.where(inexact, idxs, C)) >= run_end

        # ---- in-compilation filtering (clean.rs:657-726) ------------------
        # nodes at-or-below a cached threshold, and exact nodes dominated by
        # a snapshot entry, never materialize; their theta propagates to
        # parents.  The terminal layer is never filtered.
        pruned = false((K, C))
        ptheta = full((K, C), INF)
        pci = false((K, C))
        if cache_tab is not None and not is_last:
            tk, tv, tm = (cache_tab[x][i + 1] for x in ("keys", "vals", "valid"))
            eq = (kv[:, :, None, :] == tk[None, None]).all(dim=3) & tm
            cth = torch.where(eq, tv, NEG_INF).amax(dim=2)
            pc = head & eq.any(dim=2) & (val_s <= cth)
            pruned |= pc
            ptheta = torch.where(pc, torch.minimum(ptheta, cth), ptheta)
            # parents of a cache-pruned INEXACT node join the frontier
            # cutset (clean.rs:586-606 visits pruned nodes too)
            pci = pc & ~slot_exact
        if use_dom_snap and not is_last:
            dk, dc, dv, dm = (dom_tab[x][i + 1]
                              for x in ("keys", "coords", "vals", "valid"))
            km = (s_dkey[:, :, None, :] == dk[None, None]).all(dim=3) & dm
            ge = (dc[None, None] >= s_dcoord[:, :, None, :]).all(dim=3)
            eqc = (dc[None, None] == s_dcoord[:, :, None, :]).all(dim=3)
            # entry dominates node per partial_cmp (dominance.rs:57-79): >=
            # on every coordinate (value too under use_value) with at
            # least one strict; overall equality is NOT dominance
            if dom.use_value:
                vs = val_s[:, :, None]
                dominates = km & ge & (dv >= vs) & ~(eqc & (dv == vs))
                dthr = torch.where(dominates, torch.where(eqc, dv - 1, dv),
                                   INF).amin(dim=2)
            else:
                dominates = km & ge & ~eqc
                dthr = full((K, C), INF)
            pd = head & slot_exact & dominates.any(dim=2)
            pruned |= pd
            ptheta = torch.where(pd, torch.minimum(ptheta, dthr), ptheta)
        surv = head & ~pruned
        U = surv.sum(dim=1, dtype=I32)

        # --- squash: restrict (clean.rs:802-815) / relax (clean.rs:817-876).
        # The terminal layer is never squashed below the buffer width W.
        cap = torch.full_like(eff_width, W) if is_last else eff_width
        no = false((K,))
        need_restrict = (U > cap) if comp == CompilationType.RESTRICTED else no
        need_relax = ((U > cap) & (i + 1 - root_depths >= 2)) \
            if comp == CompilationType.RELAXED else no
        squashed = need_relax | need_restrict

        # promising first, pruned/invalid last
        q_keys = [(~surv).to(I32), -val_s] + [-s_rank[:, :, r] for r in range(R)] \
            + [neg_idxs]
        s2 = _sort(q_keys, len(q_keys))
        so_val = -s2[1]
        order2 = -s2[-1]
        so_valid = s2[0] == 0
        rank_of = seg.scatter(order2, idxs.expand(K, C))

        limit = torch.where(need_relax, cap - 1, torch.where(need_restrict, cap, C))
        kept = surv & (rank_of < limit[:, None])
        merge_mask = surv & ~kept & need_relax[:, None]

        # --- edge remap: every candidate takes its run head's code
        slot_code = (rank_of + (kept.to(I32) << 27) + (merge_mask.to(I32) << 28)
                     + (pruned.to(I32) << 29) + (pci.to(I32) << 30))
        code_s, ptheta_s = seg.seg_broadcast_at_head(head, (slot_code, ptheta))
        e_code = seg.scatter(perm, code_s)
        cand_ptheta = seg.scatter(perm, ptheta_s)
        f_mmask = seg.scatter(perm, merge_mask)

        # merged node (only meaningful under need_relax)
        merged_state = rlx.merge(rdata, f_state, f_mmask)
        merged_key = problem.pack(merged_state).to(I32)  # [K, Kk]
        eq_kept = kept & (kv == merged_key[:, None, :]).all(dim=2)
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
        if comp == CompilationType.RELAXED:
            # src is the parent's state, dst the original child state
            # (Relaxation::relax, abstraction/dp.rs:93-100)
            rcost = rlx.relax_cost(
                rdata, _flat(tmap(lambda x: x.repeat_interleave(D, dim=1), c_state), 2),
                _flat(f_state, 2),
                _flat(tmap(lambda m: m[:, None].expand((K, C) + tuple(m.shape[1:])),
                           merged_state), 2),
                f_dval.reshape(-1), f_cost.reshape(-1), var.repeat_interleave(C),
            ).to(I32).reshape(K, C)
            e_cost = torch.where(e_merge, rcost, f_cost)
        else:
            e_cost = f_cost
        e_child = torch.where(e_kept, e_code & _M27,
                              torch.where(e_merge, merged_pos[:, None], -1))
        e_valid = f_valid & (e_child >= 0)

        # theta of filter-pruned children propagates to parents
        # (clean.rs:502,522-528): per-parent min of (theta - cost)
        if filtering:
            ep = torch.where(e_pruned, sat_sub(cand_ptheta, f_cost), INF)
            P["eptheta"][:, i] = ep.view(K, W, D).amin(dim=2)

        # merged node aggregates (append_edge_to!, clean.rs:199-219)
        m_edge_val = torch.where(
            e_merge, sat_add(c_val.repeat_interleave(D, dim=1), e_cost), NEG_INF)
        m_val = m_edge_val.amax(dim=1)
        m_is_best = e_merge & (m_edge_val == m_val[:, None])
        m_best_flat = torch.where(m_is_best, idxs, -1).amax(dim=1)
        has_medge = m_best_flat >= 0
        m_best = m_best_flat.clamp(0, C - 1).long()[:, None]
        m_bp = torch.where(has_medge, m_best[:, 0].to(I32) // D, -1)
        m_bd = torch.where(has_medge, f_dval.gather(1, m_best)[:, 0], 0)

        # --- materialize the next layer: the first W ranking-sorted slots,
        # through the composition of the two sort permutations
        width_used = torch.where(squashed, torch.where(need_relax, limit + 1, cap),
                                 torch.clamp(U, max=W))
        overflow |= (U > W) & ~squashed
        order2_W = order2[:, :W].long()
        fidx_W = perm.gather(1, order2_W)
        q_valid = (q < width_used[:, None]) & so_valid[:, :W]
        nl_val = so_val[:, :W]
        nl_exact = slot_exact.gather(1, order2_W)
        nl_bp = torch.where(so_valid[:, :W], fidx_W // D, -1)
        nl_bd = f_dval.gather(1, fidx_W.long())
        # a node whose best in-edge is a long (skip) arc
        nl_bs = skip_s.gather(1, order2_W) if long_arcs else false((K, W))
        nl_state = tmap(lambda x: seg.take_rows(x, fidx_W), f_state)

        # overrides for the merged node
        is_mpos = need_relax[:, None] & (q == merged_pos[:, None])
        rec_val = val_s.gather(1, recycled_slot)[:, 0]
        mv_new = torch.where(recycled[:, None], torch.maximum(nl_val, m_val[:, None]),
                             m_val[:, None])
        take_medge = has_medge & torch.where(recycled, m_val >= rec_val, True)
        nl_val = torch.where(is_mpos, mv_new, nl_val)
        use_m = is_mpos & take_medge[:, None]
        nl_bp = torch.where(use_m, m_bp[:, None], nl_bp)
        nl_bd = torch.where(use_m, m_bd[:, None], nl_bd)
        if long_arcs:
            m_bs = has_medge & f_skip.gather(1, m_best)[:, 0]
            nl_bs = torch.where(use_m, m_bs[:, None], nl_bs)
        # the merged node is never exact, recycled or not (node_flags.rs:88-90)
        nl_exact = nl_exact & ~is_mpos
        nl_relaxed = is_mpos
        q_valid = q_valid | is_mpos
        fresh = is_mpos & ~recycled[:, None]
        nl_state = tmap(lambda m, t: torch.where(_bcast(fresh, t), m[:, None], t),
                        merged_state, nl_state)
        nl_exact = nl_exact & q_valid
        nl_relaxed = nl_relaxed & q_valid

        # ---- within-layer dominance (clean.rs:689-708, the layer-local
        # part): dominated exact rows stay in the buffer masked-invalid,
        # carrying their threshold as theta
        wl_pruned = false((K, W))
        wl_ptheta = full((K, W), INF)
        if use_dom and not is_last:
            nv = torch.where(q_valid, nl_val, NEG_INF)
            w_dkey = _cols(dom.key_cols, nl_state, (K, W))
            w_dcoord = _cols(dom.coord_cols, nl_state, (K, W))
            cand = q_valid & nl_exact
            km_ij = (w_dkey[:, :, None] == w_dkey[:, None]).all(dim=3)
            ge_ij = (w_dcoord[:, :, None] >= w_dcoord[:, None]).all(dim=3)
            eq_ij = (w_dcoord[:, :, None] == w_dcoord[:, None]).all(dim=3)
            both = cand[:, :, None] & cand[:, None, :]
            vi, vj = nv[:, :, None], nv[:, None, :]
            if dom.use_value:  # [k, i, j]: i strictly dominates j
                dom_ij = both & km_ij & ge_ij & (vi >= vj) & ~(eq_ij & (vi == vj))
            else:
                dom_ij = both & km_ij & ge_ij & ~eq_ij
            wl_pruned = dom_ij.any(dim=1)
            if dom.use_value:
                # thresholds from MAXIMAL dominators only
                maximal = cand & ~wl_pruned
                contrib = torch.where(eq_ij, vi - 1, vi)
                wl_thr = torch.where(dom_ij & maximal[:, :, None], contrib,
                                     INF).amin(dim=1)
                wl_ptheta = torch.where(wl_pruned, wl_thr, INF)

        exact_for_hic = nl_exact  # wl-pruned rows are not "inexact children"
        q_valid = q_valid & ~wl_pruned
        nl_val = torch.where(q_valid, nl_val, NEG_INF)
        nl_exact = nl_exact & q_valid
        nl_relaxed = nl_relaxed & q_valid

        # exact-best-path flag, incrementally (clean.rs:643-655)
        par_ebp = c_ebp.gather(1, nl_bp.clamp(0, W - 1).long()) & (nl_bp >= 0)
        nl_ebp = (nl_exact | (~nl_relaxed & par_ebp)) & q_valid

        # LEL (clean.rs:796-800): the layer before the first squashed one
        lel = torch.where(squashed & (lel == n + 1), i, lel)

        # frontier-cutset ingredient (clean.rs:586-606): an inexact child
        ch_inexact = e_valid & ~exact_for_hic.gather(1, e_child.clamp(0, W - 1).long())
        P["hic"][:, i] = (ch_inexact | e_pci).view(K, W, D).any(dim=2)

        _write_layer(P["state"], i, c_state)
        for name, val in (("val", c_val), ("mask", c_mask), ("exact", c_exact),
                          ("relaxed", c_relaxed), ("rub", rub), ("bp", c_bp),
                          ("bd", c_bd), ("bs", c_bs), ("wlp", c_wlp),
                          ("wlth", c_wlth)):
            P[name][:, i] = val
        E["child"][:, i] = e_child
        E["cost"][:, i] = e_cost
        E["valid"][:, i] = e_valid
        cur = dict(state=nl_state, val=nl_val, mask=q_valid, exact=nl_exact,
                   relaxed=nl_relaxed, bp=nl_bp, bd=nl_bd, bs=nl_bs & q_valid,
                   ebp=nl_ebp, wlp=wl_pruned, wlth=wl_ptheta)
    if chunked:
        poll(n)
    return finalize(spec, datas, var_of, cur, P, E, lel, expanded, overflow,
                    best_lb, root_depths, use_dom)


def finalize(spec: DDSpec, datas, var_of, term, P, E, lel, expanded, overflow,
             best_lb, root_depths, use_dom):
    """Finalization over the layer planes: best node, exactness and
    cutset planes, the fused local-bounds + thresholds backward sweep, and
    the packed key planes (ddo_tpu/engine/mdd.py:901-1061)."""
    problem = spec.bundle.problem
    n, W = problem.nb_variables, spec.width
    comp = spec.comp_type
    K = lel.shape[0]
    device = lel.device

    # the terminal layer (n) is the final carry
    _write_layer(P["state"], n, term["state"])
    for name in ("val", "mask", "exact", "relaxed", "bp", "bd", "bs", "wlp", "wlth"):
        P[name][:, n] = term[name]
    S_val, S_mask, S_exact = P["val"], P["mask"], P["exact"]

    term_mask = term["mask"]
    term_val = torch.where(term_mask, term["val"], NEG_INF)
    feasible = term_mask.any(dim=1)
    best_slot = argmax_first(term_val)
    best_value = term_val.gather(1, best_slot[:, None])[:, 0]
    texact = term_mask & term["exact"]
    tev = torch.where(texact, term["val"], NEG_INF)
    bx_feasible = texact.any(dim=1)
    bx_slot = argmax_first(tev)
    bx_value = tev.gather(1, bx_slot[:, None])[:, 0]

    is_exact_dd = lel == n + 1  # no layer was ever squashed (clean.rs:635)
    # EBPO: exact best path (clean.rs:634-655)
    if comp == CompilationType.RELAXED:
        has_ebp = feasible & term["ebp"].gather(1, best_slot[:, None])[:, 0]
    else:
        has_ebp = torch.zeros((K,), dtype=torch.bool, device=device)
    bx_feasible = bx_feasible | has_ebp
    bx_slot = torch.where(has_ebp, best_slot, bx_slot)
    bx_value = torch.where(has_ebp, best_value, bx_value)

    # --- cutset + above-cutset planes (clean.rs:547-606); within-layer
    # dominance-pruned rows count as above-cutset so their thresholds
    # reach the cache
    WLP, WLTH = P["wlp"], P["wlth"]
    do_cutset = (comp == CompilationType.RELAXED) | is_exact_dd
    dc3 = do_cutset[:, None, None]
    layer_idx = torch.arange(n + 1, device=device)[None, :, None]
    lel3 = lel[:, None, None]
    if spec.cutset_type == CutsetType.LAST_EXACT_LAYER:
        above = (S_mask | WLP) & (layer_idx <= lel3) & dc3
        cutflag = S_mask & (layer_idx == lel3) & dc3
        wl_unexplored = WLP & (layer_idx == lel3)
    else:  # FRONTIER (clean.rs:586-606)
        above = ((S_mask & S_exact) | WLP) & dc3
        cutflag = torch.zeros_like(S_mask)
        cutflag[:, :n] = S_exact[:, :n] & S_mask[:, :n] & P["hic"]
        cutflag &= dc3
        wl_unexplored = torch.zeros_like(S_mask)

    # --- fused bottom-up pass: local bounds + thresholds (kernel K2)
    do_locb = (comp == CompilationType.RELAXED) & ~is_exact_dd
    vb_n = torch.where(term_mask & do_locb[:, None], 0, NEG_INF).to(I32)
    mk_n = term_mask & do_locb[:, None]
    best_known = torch.maximum(best_lb, torch.where(bx_feasible, bx_value, NEG_INF))
    bk = best_known[:, None]
    if spec.cutset_type == CutsetType.LAST_EXACT_LAYER:
        t_init = term_mask & (bx_feasible & is_exact_dd)[:, None]
    else:
        t_init = term_mask & bx_feasible[:, None] & term["exact"]
    th_n = torch.where(t_init, bk, INF)
    th_n, hs_n = bwd.thresh_rules(bk, term_mask, term["val"], P["rub"][:, n], vb_n,
                                  cutflag[:, n], term["exact"], th_n, t_init)

    vb_stack, mk_stack, th_stack, hs_stack = bwd.fused_backward(
        E["child"], E["cost"], E["valid"], S_val[:, :n].contiguous(),
        P["rub"][:, :n].contiguous(), cutflag[:, :n].contiguous(),
        S_exact[:, :n].contiguous(), S_mask[:, :n].contiguous(),
        torch.where(mk_n, vb_n, NEG_INF), torch.where(hs_n & term_mask, th_n, INF),
        best_known.to(I32).contiguous(), P["eptheta"],
        WLP[:, :n].contiguous(), WLTH[:, :n].contiguous(),
    )
    cat = lambda a, b: torch.cat([a, b[:, None]], dim=1)
    do_thresh = do_cutset[:, None, None]
    theta = torch.where(do_thresh, cat(th_stack, th_n), INF)
    has_theta = cat(hs_stack, hs_n) & do_thresh

    # canonical packed keys and the leading ranking column of every node,
    # key-major [K, n+1, Kk, W] like ddo_tpu's planes
    lead = (K, n + 1, W)
    S_keys = _cols(problem.pack, P["state"], lead).permute(0, 1, 3, 2)
    _, _, kdata = datas
    S_rank0 = _cols(lambda s: spec.bundle.ranking.score(kdata, s),
                    P["state"], lead)[..., 0]

    out = dict(
        state=P["state"], value=S_val, mask=S_mask, exact=S_exact,
        relaxed=P["relaxed"], keys=S_keys, rank0=S_rank0, rub=P["rub"],
        bp=P["bp"], bd=P["bd"], bs=P["bs"],
        var_of=var_of,
        value_bot=cat(vb_stack, vb_n), marked=cat(mk_stack, mk_n),
        theta=theta, has_theta=has_theta, above=above, cutflag=cutflag,
        wl_pruned=WLP, wl_unexplored=wl_unexplored,
        lel=lel, is_exact_dd=is_exact_dd, has_ebp=has_ebp, feasible=feasible,
        best_slot=best_slot.to(I32), best_value=best_value,
        bx_feasible=bx_feasible, bx_slot=bx_slot.to(I32), bx_value=bx_value,
        expanded=expanded, overflow=overflow, root_depth=root_depths,
    )
    if use_dom:
        dom = spec.dominance
        out["dkey"] = _cols(dom.key_cols, P["state"], lead).permute(0, 1, 3, 2)
        out["dcoord"] = _cols(dom.coord_cols, P["state"], lead).permute(0, 1, 3, 2)
    return out


def _batch_stats(out, actives):
    """Cross-lane reductions over the active lanes: the shared best_lb and
    explored counters of the reference (parallel.rs:446-454)."""
    lane_best = torch.where(actives & out["bx_feasible"], out["bx_value"], NEG_INF)
    total = torch.where(actives, out["expanded"], 0).sum()
    return lane_best.max(), total


# ------------------------------------------------------------- host views
class _BatchPlanes:
    """Lazy host view over a batch of compiled-DD outputs: each plane
    crosses to the host on first access, for all K lanes at once (one
    `.cpu()` per plane per superstep), and is kept."""

    def __init__(self, dev):
        self._dev = dev
        self._np = {}

    def get(self, key):
        if key not in self._np:
            self._np[key] = tmap(lambda t: t.cpu().numpy(), self._dev[key])
        return self._np[key]

    def prefetch(self, keys):
        """Bring the planes `keys` to the host together (one stream
        synchronize for all of them, `extract.prefetch`)."""
        todo = {k: self._dev[k] for k in keys if k not in self._np}
        self._np.update(extract.prefetch(todo))

    def __contains__(self, key):
        return key in self._dev


class _LaneView:
    """Mapping-like per-lane view into a `_BatchPlanes` (CompiledDD.o)."""

    __slots__ = ("_batch", "_k")

    def __init__(self, batch: _BatchPlanes, k: int):
        self._batch = batch
        self._k = k

    def __getitem__(self, key):
        return tmap(lambda a: a[self._k], self._batch.get(key))

    def __contains__(self, key):
        return key in self._batch

    def get(self, key, default=None):
        return self[key] if key in self._batch else default


class BufferOverflow(RuntimeError):
    """An EXACT compilation produced a layer wider than the buffer: it
    cannot squash, so truncation would be silently wrong.  Raised by every
    `CompiledDD` query when the lane's overflow flag is set."""


class CompiledDD:
    """Host-side view over one compiled diagram (numpy), exposing the
    reference `DecisionDiagram` queries (abstraction/mdd.rs:75-113)."""

    def __init__(self, spec: DDSpec, out: _LaneView, root: SubProblem):
        self.spec = spec
        self.o = out
        self.root = root
        self.n = spec.bundle.problem.nb_variables

    def _check_overflow(self):
        if bool(self.o.get("overflow", False)):
            raise BufferOverflow(
                f"layer exceeded the buffer width W={self.spec.width} in an "
                f"unsquashable ({self.spec.comp_type.name}) compilation; "
                "increase buffer_width"
            )

    # -- queries -------------------------------------------------------------
    def is_exact(self) -> bool:
        self._check_overflow()
        return bool(self.o["is_exact_dd"]) or bool(self.o["has_ebp"])

    def best_value(self) -> Optional[int]:
        self._check_overflow()
        return int(self.o["best_value"]) if self.o["feasible"] else None

    def best_exact_value(self) -> Optional[int]:
        self._check_overflow()
        return int(self.o["bx_value"]) if self.o["bx_feasible"] else None

    def best_solution(self):
        if not self.o["feasible"]:
            return None
        return self._path(self.n, int(self.o["best_slot"]))

    def best_exact_solution(self):
        if not self.o["bx_feasible"]:
            return None
        return self._path(self.n, int(self.o["bx_slot"]))

    def _path(self, layer, slot):
        """Walk best in-edges to the DD root, then prepend the root path
        (clean.rs:325-343)."""
        vals = self.root.path_vals.copy()
        pset = self.root.path_set.copy()
        d0 = int(self.o["root_depth"])
        var_of, bd, bp, bs = (self.o[k] for k in ("var_of", "bd", "bp", "bs"))
        l, s = layer, slot
        while l > d0:
            var = int(var_of[l - 1])
            if not bs[l, s]:  # long arcs record no decision
                vals[var] = int(bd[l, s])
                pset[var] = True
            s = int(bp[l, s])
            l -= 1
            if s < 0:
                break
        return vals, pset

    def node_state(self, layer, slot):
        return tmap(lambda a: a[layer, slot], self.o["state"])

    def drain_cutset(self):
        """Yield `SubProblem`s for every marked cutset node (clean.rs:417-445)."""
        self._check_overflow()
        if not self.o["feasible"]:
            return
        best_value = int(self.o["best_value"])
        for layer, slot in np.argwhere(self.o["cutflag"] & self.o["marked"]):
            layer, slot = int(layer), int(slot)
            value = int(self.o["value"][layer, slot])
            rub = min(value + int(self.o["rub"][layer, slot]), INF)
            locb = min(value + int(self.o["value_bot"][layer, slot]), INF)
            vals, pset = self._path(layer, slot)
            yield SubProblem(
                state=self.node_state(layer, slot), value=value,
                path_vals=vals, path_set=pset, ub=min(rub, locb, best_value),
                depth=layer,
                key=np.ascontiguousarray(self.o["keys"][layer, :, slot],
                                         np.int32).tobytes(),
            )

    # ----- vectorized batch extraction ----------------------------------
    def _paths_batch(self, layers, slots):
        """Best-path walk for many nodes at once: [M, n] value/set arrays."""
        M = len(layers)
        vals = np.tile(self.root.path_vals, (M, 1)).astype(np.int32)
        pset = np.tile(self.root.path_set, (M, 1)).astype(bool)
        d0 = int(self.o["root_depth"])
        var_of, bd, bp, bs = (self.o[k] for k in ("var_of", "bd", "bp", "bs"))
        cur_l = np.asarray(layers, np.int64).copy()
        cur_s = np.asarray(slots, np.int64).copy()
        for l in range(self.n, d0, -1):
            act = cur_l == l
            if not act.any():
                continue
            var = int(var_of[l - 1])
            ss = cur_s[act]
            rec = ~bs[l, ss]  # long arcs record no decision
            vals[act, var] = np.where(rec, bd[l, ss], vals[act, var])
            pset[act, var] |= rec
            cur_s[act] = bp[l, ss]
            cur_l[act] -= 1
        return vals, pset

    def cutset_batch(self, with_dom=False):
        """Vectorized drain_cutset: (keys, depths, values, ubs, path_vals,
        path_set, scores[, dom_keys, dom_coords]) numpy arrays for every
        marked cutset node."""
        self._check_overflow()
        if not self.o["feasible"]:
            K = self.o["keys"].shape[1]
            z = np.zeros(0, np.int32)
            out = (np.zeros((0, K), np.int32), z, z, z,
                   np.zeros((0, self.n), np.int32), np.zeros((0, self.n), bool), z)
            if with_dom:
                out = out + (np.zeros((0, 1), np.int32), np.zeros((0, 1), np.int32))
            return out
        layers, slots = np.nonzero(self.o["cutflag"] & self.o["marked"])
        values = self.o["value"][layers, slots].astype(np.int64)
        rub = np.minimum(values + self.o["rub"][layers, slots], INF)
        locb = np.minimum(values + self.o["value_bot"][layers, slots], INF)
        ubs = np.minimum(np.minimum(rub, locb), int(self.o["best_value"]))
        vals, pset = self._paths_batch(layers, slots)
        out = (self.o["keys"][layers, :, slots], layers.astype(np.int32),
               values.astype(np.int32), ubs.astype(np.int32), vals, pset,
               self.o["rank0"][layers, slots].astype(np.int32))
        if with_dom:
            out = out + (
                self.o["dkey"][layers, :, slots] if "dkey" in self.o else None,
                self.o["dcoord"][layers, :, slots] if "dcoord" in self.o else None,
            )
        return out

    def cache_batch(self):
        """Vectorized cache_updates: (depths, keys, thetas, explored)."""
        layers, slots = np.nonzero(self.o["has_theta"] & self.o["above"])
        unexplored = (self.o["cutflag"][layers, slots]
                      | self.o["wl_unexplored"][layers, slots])
        return (layers.astype(np.int32), self.o["keys"][layers, :, slots],
                self.o["theta"][layers, slots], (~unexplored).astype(np.uint8))

    def cache_updates(self):
        """(depth, state_key, theta, explored) records for the barrier
        cache (clean.rs:534-545); keys are the packed int32 columns."""
        depths, keys, thetas, explored = self.cache_batch()
        for d, k, t, e in zip(depths, keys, thetas, explored):
            yield (int(d), np.ascontiguousarray(k, np.int32).tobytes(), int(t),
                   bool(e))

    def exact_nodes_batch(self):
        """(depths, dom_keys, dom_coords, values) of every live exact node,
        for the global dominance store (clean.rs:697)."""
        layers, slots = np.nonzero(self.o["exact"] & self.o["mask"])
        return (layers.astype(np.int32), self.o["dkey"][layers, :, slots],
                self.o["dcoord"][layers, :, slots], self.o["value"][layers, slots])


class CompiledBatch(list):
    """List of per-lane `CompiledDD` views plus the cross-lane reductions
    over the active lanes (two scalars read per superstep)."""

    def __init__(self, views, global_best_dev, total_expanded_dev, spec=None,
                 planes=None, actives=None):
        super().__init__(views)
        self._gbest = global_best_dev
        self._texp = total_expanded_dev
        self.spec = spec
        self._planes = planes
        #: bool [K] device tensor: the lanes the reductions count
        self.actives = actives

    @property
    def dev(self):
        """The batch's output dict of device tensors (leading lane dim),
        read by the device-side row extraction (engine/extract.py)."""
        return self._planes._dev if self._planes is not None else None

    @property
    def global_best(self) -> int:
        """Max best-exact-value across active lanes, NEG_INF if none."""
        return int(self._gbest)

    @property
    def total_expanded(self) -> int:
        """Sum of node expansions across active lanes."""
        return int(self._texp)


def paths_batch_multi(planes: _BatchPlanes, lanes, layers, slots, roots):
    """Best-path walk for rows spread across a batch's lanes: one host loop
    over layers for all rows (ddo_tpu/engine/mdd.py:1623-1664).  Each row
    stops at its own lane's root depth."""
    M = len(lanes)
    bp, bd, bs, var_of = (planes.get(k) for k in ("bp", "bd", "bs", "var_of"))
    n = var_of.shape[1]
    if M == 0:
        return np.zeros((0, n), np.int32), np.zeros((0, n), bool)
    vals = np.stack([roots[k].path_vals for k in lanes]).astype(np.int32)
    pset = np.stack([roots[k].path_set for k in lanes]).astype(bool)
    droot = np.asarray([roots[k].depth for k in lanes], np.int64)
    cur_l = np.asarray(layers, np.int64).copy()
    cur_s = np.asarray(slots, np.int64).copy()
    ln = np.asarray(lanes, np.int64)
    rows = np.arange(M)
    for l in range(n, int(droot.min()), -1):
        act = (cur_l == l) & (l > droot)
        if not act.any():
            continue
        r = rows[act]
        lr = ln[r]
        ss = cur_s[r]
        var = var_of[lr, l - 1].astype(np.int64)
        rec = ~bs[lr, l, ss]  # long arcs record no decision
        vals[r, var] = np.where(rec, bd[lr, l, ss], vals[r, var])
        pset[r, var] |= rec
        cur_s[r] = bp[lr, l, ss]
        cur_l[r] -= 1
    return vals, pset


def sort_operands(bundle: ModelBundle, dominance):
    """(sort-1 keys, sort-1 operands, sort-2 keys) of every layer's two
    sorts: sort-1 carries the validity key, the packed state words, -value
    and -index as keys, then dval, pexact, the long-arc flag, the ranking
    columns and the dominance columns as payloads; sort-2 carries the
    survivor key, -value, the ranking columns and -index."""
    problem = bundle.problem
    st = host_batch(problem.initial_state())
    Kk = problem.pack(st).shape[1]
    R = bundle.ranking.score(bundle.ranking.data("cpu"), st).shape[1]
    n_ops = 5 + Kk + R + int(has_long_arcs(problem))
    if dominance is not None and dominance.key_cols(st) is not None:
        n_ops += dominance.key_cols(st).shape[1] + dominance.coord_cols(st).shape[1]
    return 3 + Kk, n_ops, 3 + R


def _check_sort_operands(bundle: ModelBundle, dominance, width: int):
    """Raise when a layer's sorts (`sort_operands`) at buffer width
    `width` are beyond kernel K1, which sorts every layer on a card: at
    most `MAX_OPERANDS` in one call, and a lane of width * domain_size rows
    must fit one of K1's routes (the "merge" route takes any lane of up to
    `MERGE_MAX_ROWS` rows).  The plain sort of the CPU route has no such
    limit."""
    problem = bundle.problem
    nk1, n_ops, nk2 = sort_operands(bundle, dominance)
    if n_ops > sort_ops.MAX_OPERANDS:
        raise ValueError(
            f"DDCompiler: model {problem.name!r} needs {n_ops} sort operands "
            f"per layer (state key words, ranking and dominance columns); one "
            f"call of the lane sort takes {sort_ops.MAX_OPERANDS}")
    C = width * problem.domain_size
    for what, nk in (("sort-1", nk1), ("sort-2", nk2)):
        try:
            sort_ops.lane_sort_route(nk, C)
        except ValueError as e:
            raise ValueError(
                f"DDCompiler: model {problem.name!r} at width {width} has layers of "
                f"{C} candidates (width x domain size {problem.domain_size}), and "
                f"{what}'s {nk} keys over them are beyond the lane sort: {e}") from e


class DDCompiler:
    """Entry point: compiles restricted/relaxed/exact DDs for a model on
    `device`: the card ("cuda", the default, runs the kernels; without a
    card it raises) or "cpu" (the plain versions)."""

    def __init__(self, bundle: ModelBundle, width: int,
                 cutset_type: CutsetType = CutsetType.LAST_EXACT_LAYER,
                 dominance=None, *, device="cuda"):
        self.bundle = bundle
        self.width = width
        self.cutset_type = cutset_type
        self.dominance = dominance
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DDCompiler: no CUDA device for device='cuda'; pass "
                               "device='cpu' for the plain PyTorch route")
        order = bundle.problem.var_order()
        #: the static branching order, or None for a dynamic one
        self.order = None if order is None else np.asarray(order, np.int32)
        if self.device.type == "cuda":
            _check_sort_operands(bundle, dominance, width)
        self.datas = bundle.datas(self.device)
        self._specs = {ct: DDSpec(bundle, width, ct, cutset_type, dominance)
                       for ct in CompilationType}

    def _roots(self, subs, eff_widths, best_lb):
        dev = self.device
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=I32, device=dev)
        first = subs[0].state
        if isinstance(first, dict):
            states = {k: torch.as_tensor(np.stack([np.asarray(s.state[k]) for s in subs]),
                                         device=dev) for k in first}
        else:
            states = torch.as_tensor(np.stack([np.asarray(s.state) for s in subs]),
                                     device=dev)
        K = len(subs)
        lb = best_lb.expand(K) if torch.is_tensor(best_lb) else t(best_lb).expand(K)
        psets = torch.as_tensor(np.stack([np.asarray(s.path_set, bool) for s in subs]),
                                device=dev)
        return (states, t([s.value for s in subs]), t([s.depth for s in subs]),
                lb.contiguous(), t(list(eff_widths)), psets)

    def _run(self, spec, subs, roots, best_lb, cache_tab, dom_tab, cutoff=None,
             chunk_layers=None):
        states, values, depths, _, widths, psets = roots
        return compile_lanes(
            spec, self.datas, self.order, states, values, depths, best_lb, widths,
            psets, cache_tab=cache_tab, dom_tab=dom_tab, cutoff=cutoff,
            chunk_layers=chunk_layers, start=min(s.depth for s in subs),
        )

    def _batch(self, spec, subs, out, actives):
        planes = _BatchPlanes(out)
        gbest, texp = _batch_stats(out, actives)
        return CompiledBatch(
            [CompiledDD(spec, _LaneView(planes, k), sub) for k, sub in enumerate(subs)],
            gbest, texp, spec=spec, planes=planes, actives=actives,
        )

    def compile(self, comp_type: CompilationType, sub: SubProblem, best_lb: int,
                eff_width: int, cache_tab=None, dom_tab=None) -> CompiledDD:
        """One diagram (a batch of one lane)."""
        return self.compile_batch(comp_type, [sub], best_lb, [eff_width],
                                  cache_tab=cache_tab, dom_tab=dom_tab)[0]

    def compile_batch(self, comp_type: CompilationType, subs, best_lb,
                      eff_widths, cache_tab=None, dom_tab=None, cutoff=None,
                      chunk_layers=None) -> CompiledBatch:
        """Compile one diagram per subproblem in one K-lane pass.  With
        `chunk_layers` and a `cutoff`, the cutoff is polled every
        `chunk_layers` layers and `CutoffInterrupt` raised when it fires."""
        spec = self._specs[comp_type]
        roots = self._roots(subs, eff_widths, best_lb)
        out = self._run(spec, subs, roots, roots[3], cache_tab, dom_tab,
                        cutoff=cutoff, chunk_layers=chunk_layers)
        actives = torch.ones(len(subs), dtype=torch.bool, device=self.device)
        return self._batch(spec, subs, out, actives)

    def compile_fused(self, subs, best_lb, eff_widths, cache_tab=None, dom_tab=None):
        """One superstep: K restricted compiles, the cross-lane incumbent
        reduction on the device, then K relaxed compiles pruning against
        max(best_lb, restricted best).  Returns (restricted, relaxed)
        `CompiledBatch`es; the relaxed counts exclude lanes whose
        restricted DD came out exact (their relaxed planes are unread)."""
        spec_r = self._specs[CompilationType.RESTRICTED]
        spec_x = self._specs[CompilationType.RELAXED]
        roots = self._roots(subs, eff_widths, best_lb)
        actives = torch.ones(len(subs), dtype=torch.bool, device=self.device)
        out_r = self._run(spec_r, subs, roots, roots[3], cache_tab, dom_tab)
        g_r, _ = _batch_stats(out_r, actives)
        lb2 = torch.maximum(roots[3], g_r)
        out_x = self._run(spec_x, subs, roots, lb2, cache_tab, dom_tab)
        need_x = actives & ~(out_r["is_exact_dd"] | out_r["has_ebp"])
        return (self._batch(spec_r, subs, out_r, actives),
                self._batch(spec_x, subs, out_x, need_x))
