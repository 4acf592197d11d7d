"""Device-resident branch-and-bound: up to `chunk_steps` supersteps per
host sync.  Counterpart of `ddo_tpu/search/device_loop.py`.

The open subproblems live on the compile device as a fixed-capacity slab
of rows (state / value / ub / depth / path / active), and one chunk queues
whole supersteps back to back without reading anything on the host:

    pop K best rows  ->  K restricted + K relaxed compiles (`compile_lanes`)
    ->  incumbent and its path  ->  cutset rows and their paths
    ->  push into free slab slots  ->  cache and dominance row buffers.

ddo_tpu runs the chunk as one jitted `lax.while_loop`; here every decision
the loop's `cond` and `lax.cond` made is a device flag combined with
`torch.where`, and a superstep queued past the loop's end commits nothing
and counts nothing.  The host stops queueing through a flag copied
without blocking into pinned memory after each superstep and read one
superstep late, only once its CUDA event has completed (`Event.query`,
which never waits): at most `chunk_steps` supersteps are queued, and
usually one idle superstep after the slab runs dry.  The chunk's results
cross in one pinned copy per tensor and one synchronize.  No op of a
chunk synchronizes: rows are compacted with a cumsum and a scatter to a
fixed row count, never with `nonzero` or a boolean mask.

The host fringe (NoDupFringe) stays as the spill area, so cutset
branch-and-bound keeps its exact semantics (sequential.rs:329-461):

  * slab FULL         -> drain the worst rows to the host fringe, go on;
  * cutset rows > cap -> the superstep is NOT committed; the host loop
    replays it through `SequentialSolver._process_batch`, which has no
    row cap;
  * slab empty, host fringe not -> reseed the slab from the fringe.

ddo_tpu's sound divergences from the host solver stay: supersteps of one
chunk filter against the chunk-start cache/dominance snapshots, and slab
pops skip the pop-time `must_explore` and dominance probes.  Two
divergences from ddo_tpu (ROADMAP C.8, C.9): the slab dedup's runs never
span the boundary between active and inactive rows, so a dead slot never
loosens a merged ub; and `width_static` matches the TSPTW/SOP/SRFLP width
classes by class, not by their attribute names.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.heuristics import (
    DivBy,
    FixedWidth,
    NbUnassignedWidth,
    Times,
    WidthHeuristic,
)
from ddo_tpu_torch.core.types import (
    Completion,
    CompilationType,
    Reason,
    SubProblem,
    root_subproblem,
)
from ddo_tpu_torch.engine import extract as EX
from ddo_tpu_torch.engine.mdd import (
    BufferOverflow,
    CutoffInterrupt,
    _batch_stats,
    _sort,
    compile_lanes,
    tmap,
)
from ddo_tpu_torch.models.sop import SopWidth
from ddo_tpu_torch.models.srflp import SrflpWidth
from ddo_tpu_torch.models.tsptw import TsptwWidth
from ddo_tpu_torch.search.cache import EmptyCache
from ddo_tpu_torch.search.solver import SequentialSolver
from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import INF, NEG_INF, argmax_first, sat_add

I32 = torch.int32
I64 = torch.long


# --------------------------------------------------------------------------
# Width heuristics as static descriptors evaluated on the device
# --------------------------------------------------------------------------
def width_static(heu: WidthHeuristic):
    """Static descriptor of a width heuristic, evaluated on the device by
    `_eval_width`: every heuristic the reference CI uses (width.rs:166,
    397, 636, 875, and the nb_vars * (depth + 1) * factor widths of the
    tsptw/sop/srflp heuristics.rs), matched by class."""
    if isinstance(heu, FixedWidth):
        return ("fixed", int(heu.width))
    if isinstance(heu, NbUnassignedWidth):
        return ("nbu",)
    if isinstance(heu, Times):
        return ("times", int(heu.factor), width_static(heu.inner))
    if isinstance(heu, DivBy):
        return ("div", int(heu.divisor), width_static(heu.inner))
    if isinstance(heu, (TsptwWidth, SopWidth, SrflpWidth)):
        return ("lineardepth", int(heu.nb_vars), int(heu.factor))
    raise TypeError(f"{type(heu).__name__} has no device evaluation; use one of the "
                    "width_static heuristics or a host solver")


def _eval_width(desc, depth, pset):
    """int32 [K] widths of a `width_static` descriptor for rows at `depth`
    [K] with decided variables `pset` bool [K, n]."""
    kind = desc[0]
    if kind == "fixed":
        return torch.full(depth.shape, desc[1], dtype=I32, device=depth.device)
    if kind == "nbu":
        n = pset.shape[-1]
        return torch.clamp(n - pset.sum(dim=-1, dtype=I32), min=1)
    if kind == "times":
        return desc[1] * _eval_width(desc[2], depth, pset)
    if kind == "div":
        return torch.clamp(_eval_width(desc[2], depth, pset) // desc[1], min=1)
    if kind == "lineardepth":
        return (desc[1] * (depth.to(I32) + 1) * desc[2]).to(I32)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Fixed-size row selection (no op here synchronizes with the host)
# --------------------------------------------------------------------------
def _compact(mask, P):
    """(idx int64 [P], count): the flat indices of the first P set entries
    of the 1-D `mask`, in order (the rest of `idx` is 0), and how many are
    set.  ddo_tpu's `argsort(~mask, stable=True)[:P]` on its selected
    prefix."""
    N = mask.shape[0]
    pos = torch.cumsum(mask, 0)
    dst = torch.where(mask & (pos <= P), pos - 1, P)
    idx = torch.zeros(P + 1, dtype=I64, device=mask.device)
    idx.scatter_(0, dst, torch.arange(N, device=mask.device))
    return idx[:P], pos[-1]


def _partition(mask):
    """int64 [N]: the set entries of the 1-D `mask` in order, then the
    others in order, i.e. `argsort(~mask, stable=True)`, as a scatter of
    a permutation."""
    N = mask.shape[0]
    m = mask.to(I64)
    pos_t = torch.cumsum(m, 0)
    pos = torch.where(mask, pos_t - 1, pos_t[-1] + torch.cumsum(1 - m, 0) - 1)
    return torch.empty(N, dtype=I64, device=mask.device).scatter_(
        0, pos, torch.arange(N, device=mask.device))


def _take_cols(plane, idx):
    """Rows `idx` (flat over lane, layer, slot) of a [K, n1, W] plane, or
    [M, CC] of a key-major [K, n1, CC, W] one."""
    if plane.dim() == 4:
        return EX._take_cols(plane, idx)
    return plane.reshape(-1)[idx]


def _walk_paths(bp, bd, bs, var_of, lanes, layers, slots, droot, pv0, ps0,
                active, lo):
    """Best-in-edge walks for M rows spread over the lanes of [L, n+1, W]
    planes, writing decisions by variable into copies of (pv0, ps0) (the
    batched CompiledDD._path, clean.rs:325-343).  A long arc records no
    decision.  The loop runs layers n down to lo + 1 (lo <= every row's
    root depth), each row joining at its own layer and leaving at its
    lane's root; finished rows are masked, nothing is read on the host."""
    L, n1, W = bp.shape
    n = n1 - 1
    bpf, bdf, bsf = bp.reshape(-1), bd.reshape(-1), bs.reshape(-1)
    varf = var_of.reshape(-1).to(I64)
    pv, ps = pv0.clone(), ps0.clone()
    cur = torch.where(active, slots, -1)
    for l in range(n, lo, -1):
        act = active & (l <= layers) & (l > droot) & (cur >= 0)
        idx = (lanes * (n1 * W) + l * W + cur).clamp(0, L * n1 * W - 1)
        var = varf[(lanes * n + (l - 1)).clamp(0, L * n - 1)][:, None]
        rec = act & ~bsf[idx]
        pv.scatter_(1, var, torch.where(rec, bdf[idx], pv.gather(1, var)[:, 0])[:, None])
        ps.scatter_(1, var, (ps.gather(1, var)[:, 0] | rec)[:, None])
        cur = torch.where(act, bpf[idx], cur)
    return pv, ps


def _select(cond, new, old):
    """`torch.where` of a 0-dim `cond` over whole tensors."""
    return torch.where(cond.reshape((1,) * new.dim()), new, old)


def _union_rows(out_r, out_x, sel_r, sel_x, commit, M):
    """The first M rows of the union of both passes' selections (bool
    [K, n1, W], pass r's rows first), none unless `commit`: (pick, flat
    index, from_x, depth or -1 past the count, row count cut at M), with
    `pick(key)` the rows of plane `key` from their own pass."""
    K, n1, W = sel_r.shape
    N = sel_r.numel()
    idx, count = _compact(torch.cat([sel_r.reshape(-1), sel_x.reshape(-1)]) & commit, M)
    fidx, from_x = idx % N, idx >= N
    depths = torch.where(torch.arange(M, device=idx.device) < count,
                         ((fidx // W) % n1).to(I32), -1)

    def pick(key):
        sel = from_x[:, None] if out_r[key].dim() == 4 else from_x
        return torch.where(sel, _take_cols(out_x[key], fidx), _take_cols(out_r[key], fidx))

    return pick, fidx, from_x, depths, torch.clamp(count, max=M)


def _buf_append(buf, rows, m, M, B):
    """Append `m` (<= M) of the M `rows` at the cursor of buffers of B rows
    when M rows fit; else drop them (callers use this only for cache and
    dominance rows, where dropping only weakens pruning).  The M - m rows
    past the cursor are junk that the next append overwrites."""
    fits = buf["cnt"] + M <= B
    at = torch.where(fits, buf["cnt"], 0) + torch.arange(M, device=m.device)
    out = dict(buf)
    for k, r in rows.items():
        keep = fits.reshape((1,) * r.dim())
        out[k] = buf[k].index_copy(0, at, torch.where(keep, r, buf[k][at]))
    out["cnt"] = torch.where(fits, buf["cnt"] + m, buf["cnt"])
    return out


def _dedup_slab(problem, slab, ar):
    """NoDupFringe's merge rule over the slab (no_duplicate.rs:96-117):
    among active rows with equal (depth, state key) keep one, the
    max-value row, with the max ub of its run.  One multi-key sort (K1 on
    a card, one lane of Cap rows) groups the runs; the runs' boundaries
    include the active/inactive one, so inactive rows never join an
    active run.  Returns the new (act, ub); rows never move."""
    keys = problem.pack(slab["state"]).to(I32)
    Kc = keys.shape[1]
    inact = (~slab["act"]).to(I32)
    ops = [inact, slab["depth"]] + [keys[:, k] for k in range(Kc)] + [-slab["val"], ar]
    s = _sort([o[None] for o in ops], len(ops))
    sidx = s[-1][0].to(I64)
    g = torch.stack([x[0] for x in s[: 2 + Kc]], dim=1)  # inact, depth, key words
    first = torch.ones_like(sidx, dtype=torch.bool)
    first[1:] = (g[1:] != g[:-1]).any(dim=1)
    head = first & (s[0][0] == 0)
    run = torch.cumsum(first, 0) - 1
    ubmax = torch.full_like(slab["ub"], NEG_INF).scatter_reduce_(
        0, run, slab["ub"][sidx], "amax")[run]
    keep = torch.zeros_like(slab["act"]).scatter_(0, sidx, head)
    ub_new = torch.empty_like(slab["ub"]).scatter_(0, sidx, ubmax)
    return slab["act"] & keep, torch.where(keep, ub_new, slab["ub"])


# --------------------------------------------------------------------------
# The chunk
# --------------------------------------------------------------------------
def _new_bufs(cache_tab, dom_tab, Bc, Bd, device):
    z = lambda shape, dtype=I32: torch.zeros(shape, dtype=dtype, device=device)
    cnt = z((), I64)
    cbuf = dict(cnt=cnt)
    if cache_tab is not None:
        cbuf.update(keys=z((Bc, cache_tab["keys"].shape[2])),
                    depths=torch.full((Bc,), -1, dtype=I32, device=device),
                    thetas=z((Bc,)), expl=z((Bc,), torch.uint8))
    dbuf = dict(cnt=cnt)
    if dom_tab is not None:
        dbuf.update(dkeys=z((Bd, dom_tab["keys"].shape[2])),
                    dcoords=z((Bd, dom_tab["coords"].shape[2])),
                    depths=torch.full((Bd,), -1, dtype=I32, device=device),
                    values=z((Bd,)))
    return cbuf, dbuf


def _alive(slab, best, st, max_steps):
    """Whether the next superstep runs: ddo_tpu's while_loop `cond`."""
    more = (slab["act"] & (slab["ub"] > best["lb"])).any()
    return (st["steps"] < max_steps) & more & ~(st["full"] | st["cutov"] | st["hw_over"])


def _ended(flags):
    """Whether the newest superstep flag the host may read without
    waiting (its event has completed; on the CPU every flag) says the
    loop has ended.  Flags only ever turn False, so an older flag that
    says "alive" is merely out of date."""
    for flag, ev in reversed(flags[-2:]):
        if ev is None or ev.query():
            return not bool(flag)
    return False


def device_chunk(spec_r, spec_x, datas, order, slab, best, max_steps, cache_tab,
                 dom_tab, *, K, wdesc, start=0, Pcut=512, Mc=4096, Md=4096,
                 Bc=32768, Bd=32768):
    """Queue up to `max_steps` supersteps on the slab's device (see the
    module doc) and return (slab, best, cbuf, dbuf, stats), all device
    tensors.  `order` is the branching order as an int64 device tensor or
    None (dynamic), `start` the first layer every compile runs (the
    slab's minimum active depth).  `stats` flags:
      full    - the last superstep's pushes did not fit: NOT committed;
      cutov   - it had more than Pcut cutset rows: NOT committed;
      hw_over - an engine buffer overflowed (`maximize` raises).
    The host stops queueing once a superstep's flag, read one superstep
    late, says the loop has ended."""
    problem = spec_r.bundle.problem
    n = problem.nb_variables
    n1 = n + 1
    W = spec_r.width
    Cap = slab["val"].shape[0]
    dev = slab["val"].device
    Pcut = min(Pcut, K * n1 * W)
    Mc = min(Mc, 2 * K * n1 * W)
    Md = min(Md, 2 * K * n1 * W)
    ar = torch.arange(Cap, dtype=I32, device=dev)
    rank = torch.arange(Pcut, device=dev)
    st = dict(steps=torch.zeros((), dtype=I64, device=dev))
    st.update(explored=st["steps"], expanded=st["steps"])
    st.update(full=torch.zeros((), dtype=torch.bool, device=dev))
    st.update(cutov=st["full"], hw_over=st["full"])
    cbuf, dbuf = _new_bufs(cache_tab, dom_tab, Bc, Bd, dev)
    use_cache, use_dom = "keys" in cbuf, "dkeys" in dbuf

    def compile_pass(spec, rs, rv, rd, lb, ew, ps):
        return compile_lanes(spec, datas, order, rs, rv, rd, lb.expand(K).contiguous(),
                             ew, ps, cache_tab=cache_tab, dom_tab=dom_tab, start=start)

    def superstep(slab, best, cbuf, dbuf, st):
        alive = _alive(slab, best, st, max_steps)
        # opportunistic state dedup when the slab runs low on space
        occ = slab["act"].sum()
        act_d, ub_d = _dedup_slab(problem, slab, ar)
        dd = alive & (occ * 4 > Cap * 3)
        slab = dict(slab, act=torch.where(dd, act_d, slab["act"]),
                    ub=torch.where(dd, ub_d, slab["ub"]))
        lb0 = best["lb"]
        elig = slab["act"] & (slab["ub"] > lb0) & alive

        # ---- pop K best by (ub, value), ties to the lower slot (MaxUB,
        # subproblem_ranking.rs:76-91)
        s = _sort([(~elig).to(I32)[None], -slab["ub"][None], -slab["val"][None],
                   ar[None]], 4)
        idxK = s[3][0, :K].to(I64)
        lane_ok = elig[idxK]
        idx = torch.where(lane_ok, idxK, idxK[0])
        act1 = slab["act"].scatter(0, idxK, slab["act"][idxK] & ~lane_ok)
        rs = tmap(lambda a: a[idx], slab["state"])
        rv, rd, node_ub = slab["val"][idx], slab["depth"][idx], slab["ub"][idx]
        ps, rpv = slab["pset"][idx], slab["pvals"][idx]
        ew = _eval_width(wdesc, rd, ps)

        # ---- the two passes, the relaxed one pruning against the
        # restricted one's incumbent
        out_r = compile_pass(spec_r, rs, rv, rd, lb0, ew, ps)
        g_r, t_r = _batch_stats(out_r, lane_ok)
        lb1 = torch.maximum(lb0, g_r)
        out_x = compile_pass(spec_x, rs, rv, rd, lb1, ew, ps)
        need_x = lane_ok & ~(out_r["is_exact_dd"] | out_r["has_ebp"])
        g_x, t_x = _batch_stats(out_x, need_x)
        lb2 = torch.maximum(lb1, g_x)
        hw_over = ((out_r["overflow"] & lane_ok) | (out_x["overflow"] & need_x)).any()

        # ---- incumbent (maybe_update_best, sequential.rs:394-400); its
        # lane is a [1] tensor: indexing with a 0-dim one reads it on the host
        improved = lb2 > lb0
        use_x = g_x > torch.maximum(lb0, g_r)
        lane_r = argmax_first(torch.where(lane_ok & out_r["bx_feasible"],
                                          out_r["bx_value"], NEG_INF)).reshape(1)
        lane_x = argmax_first(torch.where(need_x & out_x["bx_feasible"],
                                          out_x["bx_value"], NEG_INF)).reshape(1)
        lane = torch.where(use_x, lane_x, lane_r)
        bslot = torch.where(use_x, out_x["bx_slot"][lane_x], out_r["bx_slot"][lane_r])

        # ---- cutset rows (drain_cutset, clean.rs:417-445)
        act_cut = need_x & ~(out_x["is_exact_dd"] | out_x["has_ebp"])
        sel = (out_x["cutflag"] & out_x["marked"]
               & (act_cut & out_x["feasible"])[:, None, None]).reshape(-1)
        cidx, cut_count = _compact(sel, Pcut)
        cutov = cut_count > Pcut
        lanes = cidx // (n1 * W)
        layers = (cidx // W) % n1
        slots = cidx % W
        v = out_x["value"].reshape(-1)[cidx]
        ub_row = torch.minimum(
            torch.minimum(sat_add(v, out_x["rub"].reshape(-1)[cidx]),
                          sat_add(v, out_x["value_bot"].reshape(-1)[cidx])),
            out_x["best_value"].to(I32)[lanes])
        ub_row = torch.minimum(ub_row, node_ub[lanes])
        keep = (rank < cut_count) & (ub_row > lb2)

        # ---- one walk for the cutset rows (relaxed planes, lanes K..2K)
        # and the incumbent (row Pcut, on the planes of its pass)
        cat = lambda key: torch.cat([out_r[key], out_x[key]])
        pv, psm = _walk_paths(
            cat("bp"), cat("bd"), cat("bs"), cat("var_of"),
            torch.cat([lanes + K, lane + K * use_x]),
            torch.cat([layers, layers.new_full((1,), n)]),
            torch.cat([slots, bslot.to(I64)]),
            torch.cat([rd[lanes], rd[lane]]).to(I64),
            torch.cat([rpv[lanes], rpv[lane]]), torch.cat([ps[lanes], ps[lane]]),
            torch.cat([keep, improved.reshape(1)]), start)
        best = dict(lb=lb2, vals=torch.where(improved, pv[Pcut], best["vals"]),
                    set=torch.where(improved, psm[Pcut], best["set"]),
                    has=best["has"] | improved)
        cstates = tmap(lambda a: a.reshape((K * n1 * W,) + tuple(a.shape[3:]))[cidx],
                       out_x["state"])

        # ---- push: the k-th kept row into the k-th free slot
        free = ~act1
        push_cnt = keep.sum()
        full_now = push_cnt > free.sum()
        korder = _partition(keep)
        dest = _partition(free)[:Pcut]
        write = (rank < push_cnt) & ~full_now & ~cutov

        def push(a, rows):
            w = write.reshape((Pcut,) + (1,) * (rows.dim() - 1))
            return a.index_copy(0, dest, torch.where(w, rows[korder], a[dest]))

        slab2 = dict(
            state=tmap(push, slab["state"], cstates), val=push(slab["val"], v),
            ub=push(slab["ub"], ub_row), depth=push(slab["depth"], layers.to(I32)),
            pvals=push(slab["pvals"], pv[:Pcut]), pset=push(slab["pset"], psm[:Pcut]),
            act=push(act1, keep))
        # rows whose ub fell to the new incumbent are dead
        slab2["act"] = slab2["act"] & (slab2["ub"] > lb2)
        # a cutset-overflow or slab-full superstep is not committed (the
        # host loop replays it); its incumbent is
        commit = alive & ~cutov & ~full_now
        slab = {k: (tmap(lambda a, b: _select(commit, a, b), new, slab[k]) if k == "state"
                    else _select(commit, new, slab[k])) for k, new in slab2.items()}

        # ---- cache threshold rows of both passes, gated on commit: a
        # threshold of an unexplored node is sound only once its cutset
        # subproblem is in a fringe (ddo_tpu/search/device_loop.py:468-475)
        if use_cache:
            pick, fidx, from_x, depths, m = _union_rows(
                out_r, out_x, out_r["has_theta"] & out_r["above"] & lane_ok[:, None, None],
                out_x["has_theta"] & out_x["above"] & need_x[:, None, None], commit, Mc)
            unexp = lambda o: (o["cutflag"] | o["wl_unexplored"]).reshape(-1)[fidx]
            cbuf = _buf_append(cbuf, dict(
                keys=pick("keys"), depths=depths, thetas=pick("theta"),
                expl=(~torch.where(from_x, unexp(out_x), unexp(out_r))).to(torch.uint8),
            ), m, Mc, Bc)

        # ---- dominance rows (exact_nodes_batch's row set), gated alike
        if use_dom:
            pick, _, _, depths, m = _union_rows(
                out_r, out_x, out_r["exact"] & out_r["mask"] & lane_ok[:, None, None],
                out_x["exact"] & out_x["mask"] & need_x[:, None, None], commit, Md)
            dbuf = _buf_append(dbuf, dict(dkeys=pick("dkey"), dcoords=pick("dcoord"),
                                          depths=depths, values=pick("value")), m, Md, Bd)

        st = dict(
            steps=st["steps"] + commit.to(I64),
            explored=st["explored"] + torch.where(commit, lane_ok.sum(), 0),
            expanded=st["expanded"] + torch.where(commit, t_r + t_x, 0),
            full=torch.where(alive, full_now & ~cutov, st["full"]),
            cutov=torch.where(alive, cutov, st["cutov"]),
            hw_over=st["hw_over"] | (alive & hw_over),
        )
        return slab, best, cbuf, dbuf, st

    flags = []  # (host flag, its CUDA event or None) per queued superstep
    for _ in range(max_steps):
        if _ended(flags):
            break
        slab, best, cbuf, dbuf, st = superstep(slab, best, cbuf, dbuf, st)
        nxt = _alive(slab, best, st, max_steps)
        if dev.type == "cuda":
            flag = torch.empty((), dtype=torch.bool, pin_memory=True)
            flag.copy_(nxt, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            flags.append((flag, ev))
        else:
            flags.append((nxt, None))

    act = slab["act"] & (slab["ub"] > best["lb"])
    stats = dict(st, n_active=act.sum(),
                 ub_max=torch.where(act, slab["ub"], NEG_INF).max(),
                 min_depth=torch.where(act, slab["depth"], n).min())
    return slab, best, cbuf, dbuf, stats


# --------------------------------------------------------------------------
# The host loop
# --------------------------------------------------------------------------
class DeviceLoopSolver(SequentialSolver):
    """Branch-and-bound whose fringe lives on the compile device (see the
    module doc): the `SequentialSolver` surface, with `batch` the lanes K
    per superstep, `slab_cap` the device fringe's rows and `chunk_steps`
    the supersteps per host sync.  `device="cuda"` by default (raises
    without a card); `device="cpu"` runs the plain versions.  Set
    `sync_debug` to a `torch.cuda.set_sync_debug_mode` level ("warn",
    "error") to have every chunk run under it."""

    def __init__(self, bundle, slab_cap: int = 4096, chunk_steps: int = 16,
                 cut_cap: int = 512, **kw):
        super().__init__(bundle, **kw)
        self.slab_cap = int(slab_cap)
        self.chunk_steps = int(chunk_steps)
        self.cut_cap = int(cut_cap)
        if self.cut_cap > self.slab_cap // 2:
            # liveness: after a slab-full drain keeps slab_cap // 2 rows, the
            # next superstep's <= cut_cap pushes must fit the freed half
            raise ValueError("cut_cap must be <= slab_cap // 2")
        if self.batch > self.slab_cap:
            raise ValueError("batch must be <= slab_cap")
        self._wdesc = width_static(self.width_heu)
        self._n = self.problem.nb_variables
        order = self.compiler.order
        self._order = None if order is None else torch.as_tensor(
            order, dtype=I64, device=self.device)
        self.sync_debug = None
        #: chunk dispatches / cutset-overflow replays / slab-full drains /
        #: fringe reseeds
        self.loop_events = dict(chunks=0, cutov=0, full=0, seeds=0)

    # ------------------------------------------------------------- slab ops
    def _empty_slab(self, root_state):
        Cap, n, dev = self.slab_cap, self._n, self.device
        z = lambda shape, dtype=I32: torch.zeros(shape, dtype=dtype, device=dev)
        state = tmap(lambda x: torch.zeros((Cap,) + np.shape(x),
                                           dtype=torch.as_tensor(np.asarray(x)).dtype,
                                           device=dev), root_state)
        return dict(state=state, val=z((Cap,)),
                    ub=torch.full((Cap,), NEG_INF, dtype=I32, device=dev),
                    depth=z((Cap,)), pvals=z((Cap, n)), pset=z((Cap, n), torch.bool),
                    act=z((Cap,), torch.bool))

    def _seed_slab(self, slab, subs):
        """Write host subproblems into the first len(subs) slots (the slab
        must be empty)."""
        m, dev = len(subs), self.device
        t = lambda rows, dtype=I32: trace.wait(torch.as_tensor, np.asarray(rows), dtype=dtype,
                                               device=dev)
        out = dict(slab)
        out["state"] = tmap(lambda a, *xs: a.index_copy(
            0, torch.arange(m, device=dev), t(np.stack([np.asarray(x) for x in xs]), a.dtype)),
            slab["state"], *[s.state for s in subs])
        rows = dict(val=t([s.value for s in subs]),
                    ub=t([min(s.ub, INF) for s in subs]),
                    depth=t([s.depth for s in subs]),
                    pvals=t(np.stack([s.path_vals for s in subs])),
                    pset=t(np.stack([s.path_set for s in subs]), torch.bool),
                    act=torch.ones(m, dtype=torch.bool, device=dev))
        for k, r in rows.items():
            out[k] = slab[k].index_copy(0, torch.arange(m, device=dev), r)
        return out

    def _drain_slab(self, slab, keep_best: int = 0):
        """Move the active slab rows into the host fringe; with `keep_best`
        the best (ub, value) rows stay on the device."""
        h = EX.prefetch(dict(act=slab["act"], ub=slab["ub"], val=slab["val"]))
        act, ub, val = h["act"], h["ub"], h["val"]
        rows = np.flatnonzero(act)
        if len(rows) == 0:
            return slab
        keepm = np.zeros(act.shape, bool)
        if keep_best > 0:
            order = rows[np.lexsort((-val[rows], -ub[rows]))]
            keepm[order[:keep_best]] = True
            rows = order[keep_best:]
        slab = dict(slab, act=trace.wait(torch.as_tensor, keepm, device=self.device))
        if len(rows) == 0:
            return slab
        ridx = trace.wait(torch.as_tensor, rows, dtype=I64, device=self.device)
        sel = tmap(lambda a: a[ridx], slab["state"])
        h = EX.prefetch(dict(state=sel, keys=self.problem.pack(sel).to(I32),
                             pvals=slab["pvals"][ridx], pset=slab["pset"][ridx],
                             depth=slab["depth"][ridx]))
        for j, i in enumerate(rows):
            sub = SubProblem(
                state=tmap(lambda a: a[j], h["state"]), value=int(val[i]),
                path_vals=h["pvals"][j].copy(), path_set=h["pset"][j].copy(),
                ub=int(ub[i]), depth=int(h["depth"][j]),
                key=np.ascontiguousarray(h["keys"][j]).tobytes())
            before = len(self.fringe)
            self.fringe.push(sub)
            self.open_by_layer[sub.depth] += len(self.fringe) - before
        return slab

    # ------------------------------------------------------------------ API
    def maximize(self) -> Completion:
        clock = self._clock = trace.Phases(self.stats)
        clock.lap("pop")
        self.cache.initialize(self.problem)
        if self.filtering:
            self.dominance.prime(self.problem)
        root = root_subproblem(self.problem)
        self.fringe.push(root)
        self.open_by_layer[0] += 1

        spec_r = self.compiler._specs[CompilationType.RESTRICTED]
        spec_x = self.compiler._specs[CompilationType.RELAXED]
        dev = self.device
        slab = self._empty_slab(root.state)
        best = dict(lb=trace.wait(torch.tensor, self.best_lb, dtype=I32, device=dev),
                    vals=torch.zeros(self._n, dtype=I32, device=dev),
                    set=torch.zeros(self._n, dtype=torch.bool, device=dev),
                    has=torch.zeros((), dtype=torch.bool, device=dev))
        dev_lb = self.best_lb  # best["lb"] as of the last host read
        n_active = 0
        aborted = False
        self._min_depth = 0

        while True:
            clock.lap("pop")
            if self.cutoff.must_stop():
                self._abort_device(slab, n_active)
                aborted = True
                break
            if n_active == 0:
                batch = self._workload_for_seed()
                if not batch:
                    break
                slab = self._seed_slab(slab, batch)
                n_active = len(batch)
                self._min_depth = min(s.depth for s in batch)
                self.loop_events["seeds"] += 1
            if dev_lb < self.best_lb:
                best = dict(best, lb=trace.wait(torch.tensor, self.best_lb, dtype=I32,
                                                device=dev))
                dev_lb = self.best_lb

            clock.lap("snapshot", "restricted_s")
            cache_tab, dom_tab = self._filter_tables()
            if isinstance(self.cache, EmptyCache):
                cache_tab = None
            clock.lap("compile", "restricted_s")
            self.loop_events["chunks"] += 1
            slab, best, h = self._run_chunk(spec_r, spec_x, slab, best, cache_tab, dom_tab)

            # ---- absorb the chunk's results
            clock.lap("absorb", "host_s")
            s = h["stats"]
            if s["hw_over"]:
                raise BufferOverflow(f"layer exceeded the static buffer width "
                                     f"W={spec_r.width} inside the device loop")
            self.stats.supersteps += int(s["steps"])
            self.explored_count += int(s["explored"])
            self.expanded_nodes += int(s["expanded"])
            dev_lb = s["lb"]
            if dev_lb > self.best_lb and s["has"]:
                self.best_lb = dev_lb
                self.best_sol = (h["vals"].copy(), h["set"].copy())
            self._absorb_bufs(h["cbuf"], h["dbuf"])
            n_active = int(s["n_active"])
            if n_active:
                self._min_depth = int(s["min_depth"])
            ubm = int(s["ub_max"]) if n_active else NEG_INF
            self.best_ub = min(self.best_ub, max(self.best_lb, ubm, self._fringe_ub_max()))

            if s["cutov"]:
                # replay the uncommitted superstep through the host path
                clock.lap("absorb")
                self.loop_events["cutov"] += 1
                slab = self._drain_slab(slab)
                n_active = 0
                clock.lap("pop")
                batch = self._get_workload()
                if batch:
                    try:
                        self._process_batch(batch)
                    except CutoffInterrupt:
                        clock.lap("pop")
                        self._abort(Reason.CUTOFF_OCCURRED, batch)
                        aborted = True
                        break
                    self.stats.supersteps += 1
            elif s["full"]:
                clock.lap("absorb")
                self.loop_events["full"] += 1
                slab = self._drain_slab(slab, keep_best=self.slab_cap // 2)
                n_active = min(n_active, self.slab_cap // 2)

        clock.stop()
        if not aborted and self.abort_proof is None:
            self.best_ub = self.best_lb
        return Completion(
            is_exact=self.abort_proof is None,
            best_value=self.best_lb if self.best_sol is not None else None,
        )

    # ------------------------------------------------------------ internals
    _SCALARS = ("steps", "explored", "expanded", "full", "cutov", "hw_over",
                "n_active", "ub_max", "min_depth")

    def _run_chunk(self, spec_r, spec_x, slab, best, cache_tab, dom_tab):
        """Queue one chunk, then bring its results to the host: one tensor
        of every scalar, the incumbent's path and the row buffers, each in
        one pinned copy, and one synchronize.  Returns (slab, best, host
        results)."""
        guard = self.sync_debug is not None and self.device.type == "cuda"
        if guard:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(self.sync_debug)
        try:
            slab, best, cbuf, dbuf, stats = device_chunk(
                spec_r, spec_x, self.compiler.datas, self._order, slab, best,
                self.chunk_steps, cache_tab, dom_tab, K=self.batch, wdesc=self._wdesc,
                start=self._min_depth, Pcut=self.cut_cap)
            scalars = torch.stack([stats[k].to(I64) for k in self._SCALARS]
                                  + [best["lb"].to(I64), best["has"].to(I64)])
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(prev)
        self._clock.lap("extract", "restricted_s")  # the chunk is queued; read it
        h = EX.prefetch(dict(scalars=scalars, vals=best["vals"], set=best["set"],
                             cbuf=cbuf, dbuf=dbuf))
        sc = [int(x) for x in h["scalars"]]
        h["stats"] = dict(zip(self._SCALARS + ("lb", "has"), sc))
        return slab, best, h

    def _workload_for_seed(self):
        """Pop up to slab_cap // 2 subproblems for seeding, with
        `_get_workload`'s pop-time pruning.  They count as explored when
        the device loop pops them, so the host count is rolled back."""
        saved = self.batch
        try:
            self.batch = max(1, self.slab_cap // 2)
            batch = self._get_workload()
        finally:
            self.batch = saved
        if batch:
            self.explored_count -= len(batch)
        return batch or []

    def _fringe_ub_max(self):
        if self.fringe.is_empty():
            return NEG_INF
        by_state = getattr(self.fringe, "_by_state", None)
        if by_state is not None:
            return max(s.ub for s in by_state.values())
        return INF  # another fringe type: stay conservative

    def _absorb_bufs(self, cbuf, dbuf):
        """Feed the chunk's cache and dominance rows (host arrays) to the
        stores; rows with a negative depth are padding."""
        if "keys" in cbuf and cbuf["cnt"]:
            c = int(cbuf["cnt"])
            ok = cbuf["depths"][:c] >= 0
            self.cache.update_batch(cbuf["depths"][:c][ok], cbuf["keys"][:c][ok],
                                    cbuf["thetas"][:c][ok], cbuf["expl"][:c][ok])
        if "dkeys" in dbuf and dbuf["cnt"]:
            c = int(dbuf["cnt"])
            ok = dbuf["depths"][:c] >= 0
            self.dominance.insert_batch(dbuf["depths"][:c][ok], dbuf["dkeys"][:c][ok],
                                        dbuf["dcoords"][:c][ok], dbuf["values"][:c][ok])

    def _abort_device(self, slab, n_active):
        """Bound recovery on cutoff (parallel.rs:479-497): the best open
        ub over the slab and the host fringe caps the proved upper bound."""
        self.abort_proof = Reason.CUTOFF_OCCURRED
        ubm = NEG_INF
        if n_active:
            h = EX.prefetch(dict(act=slab["act"], ub=slab["ub"]))
            if h["act"].any():
                ubm = int(h["ub"][h["act"]].max())
        self.best_ub = min(self.best_ub, max(self.best_lb, ubm, self._fringe_ub_max()))
        self.fringe.clear()
        self.cache.clear()
