"""Branch-and-bound solvers driving batched DD compilations on a device.

Counterpart of `ddo_tpu/search/solver.py`:
  * `SequentialSolver` (reference sequential.rs:202-526):
    `SequentialSolver(batch=1)` reproduces its node-at-a-time loop;
  * `ParallelSolver` (parallel.rs:287-653): instead of worker threads on a
    shared fringe, each superstep pops up to K subproblems and compiles K
    restricted, then K relaxed, DDs in one K-lane engine pass;
  * `NativeSolver`: the same superstep around the C++ fringe and cache of
    `native/`.

Extraction has two routes.  The plane route copies every plane the host
reads to the host once (one `.cpu()` per plane, for all lanes) and selects
rows with numpy.  The compact route (`engine/extract.py`, `_compact`, on
by default for a CUDA device) selects the cache rows, the dominance rows
and the cutset on the device and copies only those, plus the small
per-lane planes, through pinned buffers.  Cutset branch-and-bound is exploration-order independent,
so popping K nodes changes when incumbents and thresholds appear, never
the proved optimum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ddo_tpu_torch.core.heuristics import Cutoff, FixedWidth, NoCutoff, WidthHeuristic
from ddo_tpu_torch.core.problem import ModelBundle
from ddo_tpu_torch.core.types import (
    Completion,
    CompilationType,
    CutsetType,
    Reason,
    SubProblem,
    root_subproblem,
)
from ddo_tpu_torch.engine import extract as EX
from ddo_tpu_torch.engine.mdd import CutoffInterrupt, DDCompiler, paths_batch_multi
from ddo_tpu_torch.native import NativeSearch
from ddo_tpu_torch.search.cache import Cache, EmptyCache, SimpleCache
from ddo_tpu_torch.search.dominance import DominanceChecker, EmptyDominanceChecker
from ddo_tpu_torch.search.fringe import Fringe, NoDupFringe
from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import INF, NEG_INF


@dataclasses.dataclass
class SolverStats:
    """A solve's wall times on the host (`time.perf_counter` seconds) and
    counts, filled by its phase clock (`utils/trace.py`).

    Five phases tile the solve, so they add up to `total_s`: `pop_s`
    (set-up, cache and dominance eviction by layer, fringe pops and their
    probes, the cutoff), `snapshot_s` (the filter tables), `compile_s`
    (the host's time queueing the compiles; a device-loop chunk's
    whole host time), `extract_s` (reading the compiled batches on the host: the
    compact rows, the planes and scalars the superstep reads, their waits)
    and `absorb_s` (incumbent, cache and dominance rows, cutset rows and
    their paths, fringe pushes).  The plane route reads its planes lazily,
    inside `absorb_s`.

    The older fields cut the same wall otherwise: `restricted_s` is the
    restricted compile with its snapshot and compact extraction (on the
    fused route both compiles), `relaxed_s` the relaxed one on the
    two-pass route, `host_s` the upkeep after each of them; pops,
    snapshots before a chunk and slab drains are in none of them.

    `layers` counts layer-loop iterations (n - start per compile),
    `host_syncs` the waits on the device (`trace.wait`), `supersteps` the
    K-lane compiles of popped subproblems.  `start_ns` and `end_ns` bracket
    the solve on `time.time_ns()`, the clock of the profiler's events."""

    restricted_s: float = 0.0
    relaxed_s: float = 0.0
    host_s: float = 0.0
    supersteps: int = 0
    start: float = 0.0
    total_s: float = 0.0
    pop_s: float = 0.0
    snapshot_s: float = 0.0
    compile_s: float = 0.0
    extract_s: float = 0.0
    absorb_s: float = 0.0
    layers: int = 0
    host_syncs: int = 0
    start_ns: int = 0
    end_ns: int = 0

    def expansions_per_sec(self, expanded: int) -> float:
        """Node expansions per second of the compiles' host time."""
        return expanded / self.compile_s if self.compile_s > 0 else 0.0

    def summary(self, explored: int, expanded: int) -> str:
        return (
            f"supersteps={self.supersteps} explored={explored} "
            f"expanded={expanded} layers={self.layers} pop={self.pop_s:.3f}s "
            f"snapshot={self.snapshot_s:.3f}s compile={self.compile_s:.3f}s "
            f"extract={self.extract_s:.3f}s absorb={self.absorb_s:.3f}s "
            f"total={self.total_s:.3f}s host_syncs={self.host_syncs} "
            f"rate={self.expansions_per_sec(expanded):,.0f} nodes/s"
        )


class SequentialSolver:
    """Best-first branch-and-bound over exact cutsets (sequential.rs:202);
    with `batch > 1` each iteration pops up to `batch` subproblems and
    compiles them as one K-lane pass on `device`."""

    def __init__(
        self,
        bundle: ModelBundle,
        width_heu: Optional[WidthHeuristic] = None,
        buffer_width: Optional[int] = None,
        cutset_type: CutsetType = CutsetType.LAST_EXACT_LAYER,
        cache: Optional[Cache] = None,
        dominance: Optional[DominanceChecker] = None,
        cutoff: Optional[Cutoff] = None,
        fringe: Optional[Fringe] = None,
        batch: int = 1,
        subproblem_ranking=None,
        in_compile_filtering: bool = True,
        compile_chunk: Optional[int] = None,
        *,
        device="cuda",
    ):
        self.bundle = bundle
        problem = bundle.problem
        self.problem = problem
        self.width_heu = width_heu or FixedWidth(max(2, problem.domain_size))
        W = buffer_width
        if W is None:
            # buffer must hold any unsquashed layer: relaxed DDs never squash
            # their first DD layer (clean.rs:788-793), which holds <= D nodes
            W = max(problem.domain_size,
                    max(2, self.width_heu.max_width(root_subproblem(problem))))
        # static buffer rounded up to a power of two (>= 8)
        W = max(8, 1 << (int(W) - 1).bit_length())
        self.cache = cache if cache is not None else EmptyCache()
        self.dominance = dominance if dominance is not None else EmptyDominanceChecker()
        # in-compilation filtering (clean.rs:689-726): prune each layer
        # against snapshots of the cache/dominance stores
        self.filtering = in_compile_filtering
        dom_obj = self.dominance.dom if self.filtering else None
        self.device = torch.device(device)
        self.compiler = DDCompiler(bundle, W, cutset_type, dominance=dom_obj,
                                   device=self.device)
        self.cutoff = cutoff or NoCutoff()
        # chunked compiles let a real cutoff interrupt a long compilation
        # (the reference polls per layer, clean.rs:352-354)
        if compile_chunk is None and not isinstance(self.cutoff, NoCutoff):
            compile_chunk = 32
        self.compile_chunk = compile_chunk
        self.fringe = fringe if fringe is not None else NoDupFringe(subproblem_ranking)
        self.batch = batch
        # device-side row extraction (engine/extract.py): on for a card,
        # where whole planes would cross PCIe; off on the CPU, where a
        # plane "copy" is free.  A/B runs and tests set the attribute.
        self._compact = self.device.type == "cuda"

        self.best_lb = NEG_INF
        self.best_ub = INF
        self.best_sol = None  # (vals, set_mask)
        self.abort_proof = None
        self.explored_count = 0
        self.expanded_nodes = 0  # total DD node expansions (bench metric)
        self.open_by_layer = np.zeros(problem.nb_variables + 1, np.int64)
        self.first_active_layer = 0
        self.stats = SolverStats()
        # `maximize` starts a clock of its own; this one times a superstep
        # run alone
        self._clock = trace.Phases(self.stats)

    # ------------------------------------------------------------------ API
    def maximize(self) -> Completion:
        """sequential.rs:475-494."""
        clock = self._clock = trace.Phases(self.stats)
        clock.lap("pop")
        self.cache.initialize(self.problem)
        if self.filtering:
            self.dominance.prime(self.problem)
        self.fringe.push(root_subproblem(self.problem))
        self.open_by_layer[0] += 1

        while True:
            clock.lap("pop")
            batch = self._get_workload()
            if batch is None:
                break
            if self.cutoff.must_stop():
                self._abort(Reason.CUTOFF_OCCURRED, batch)
                break
            try:
                self._process_batch(batch)
            except CutoffInterrupt:
                # the cutoff fired inside a chunked compilation
                clock.lap("pop")
                self._abort(Reason.CUTOFF_OCCURRED, batch)
                break
            self.stats.supersteps += 1

        clock.stop()
        if self.abort_proof is None:
            self.best_ub = self.best_lb
        return Completion(
            is_exact=self.abort_proof is None,
            best_value=self.best_lb if self.best_sol is not None else None,
        )

    def best_value(self):
        return self.best_lb if self.best_sol is not None else None

    def best_solution(self):
        return self.best_sol

    def best_lower_bound(self):
        return self.best_lb

    def best_upper_bound(self):
        return self.best_ub

    def set_primal(self, value, solution):
        """abstraction/solver.rs:77, parallel.rs:630-636."""
        if value > self.best_lb:
            self.best_lb = value
            self.best_sol = solution

    def gap(self) -> float:
        """abstraction/solver.rs:80-93."""
        ub, lb = self.best_ub, self.best_lb
        if ub >= INF or lb <= NEG_INF:
            return 1.0
        u, l = max(abs(ub), abs(lb)), min(abs(ub), abs(lb))
        return (u - l) / u if u else 0.0

    def explored(self):
        return self.explored_count

    # ----------------------------------------------------------- internals
    def _get_workload(self):
        """Pop up to `batch` still-relevant subproblems (sequential.rs:433-461)."""
        n = self.problem.nb_variables
        # layer-sweep cache eviction (sequential.rs:436-440)
        while (self.first_active_layer < n
               and self.open_by_layer[self.first_active_layer] == 0):
            self.cache.clear_layer(self.first_active_layer)
            self.dominance.clear_layer(self.first_active_layer)
            self.first_active_layer += 1

        while True:
            batch = []
            while len(batch) < self.batch:
                node = self.fringe.pop()
                if node is None:
                    break
                self.explored_count += 1
                self.open_by_layer[node.depth] -= 1
                self.best_ub = min(self.best_ub, max(node.ub, self.best_lb))
                if node.ub <= self.best_lb:
                    continue  # sequential.rs:337-339
                if not self.cache.must_explore(node):
                    continue  # sequential.rs:341-343
                # pop-time dominance probe: a popped node may have become
                # dominated since its enqueue (clean.rs:674)
                if self.filtering and self.dominance.dom is not None:
                    if node.dom_key is not None:
                        dominated = self.dominance.is_dominated_cols(
                            node.dom_key, node.dom_coords, node.depth, node.value)
                    else:
                        dominated = self.dominance.is_dominated(
                            node.state, node.depth, node.value)
                    if dominated:
                        continue
                batch.append(node)
            if batch:
                return batch
            if self.fringe.is_empty():
                return None

    def _filter_tables(self):
        """Snapshot the cache/dominance stores as device filter tables."""
        if not self.filtering:
            return None, None
        dev = self.compiler.device
        return self.cache.snapshot(dev), self.dominance.snapshot(dev)

    # ------- device-side compact extraction (engine/extract.py) ----------
    #: per-lane scalars every superstep reads
    _LANE_PLANES = ("is_exact_dd", "has_ebp", "bx_feasible", "bx_value", "bx_slot",
                    "overflow", "feasible", "best_value", "root_depth")
    #: planes a best-path walk reads
    _PATH_PLANES = ("bp", "bd", "bs", "var_of")

    def _extract_batch(self, cb, want_cutset=False):
        """Select the compact rows of one compiled batch on the device and
        bring them to the host together with the small per-lane planes the
        superstep reads: one synchronize for all of it.  `cb.actives`
        already leaves out a fused relaxed batch's lanes whose restricted
        DD came out exact."""
        dev, act = cb.dev, cb.actives
        K, n1, W = dev["value"].shape
        Mc, Md, Mu = EX.extract_caps(K, n1, W)
        use_dom = self.filtering and self.dominance.dom is not None and "dkey" in dev
        res = {}
        if not isinstance(self.cache, EmptyCache):
            res["cache"] = EX.cache_rows(
                dev["has_theta"], dev["above"], dev["cutflag"], dev["wl_unexplored"],
                dev["theta"], dev["keys"], act, M=Mc)
        if use_dom:
            res["dom"] = EX.exact_rows(dev["exact"], dev["mask"], dev["value"],
                                       dev["dkey"], dev["dcoord"], act, M=Md)
        planes = self._LANE_PLANES
        if want_cutset:
            act_cut = act & ~(dev["is_exact_dd"] | dev["has_ebp"])
            zcols = dev["keys"][:, :, :0, :]
            res["cut"] = EX.cutset_rows(
                dev["cutflag"], dev["marked"], dev["value"], dev["rub"],
                dev["value_bot"], dev["rank0"], dev["keys"], dev["best_value"],
                dev["feasible"], dev.get("dkey", zcols), dev.get("dcoord", zcols),
                act_cut, M=Mu, with_dom=use_dom)
            planes = planes + self._PATH_PLANES
        cb._planes.prefetch(planes)
        return EX.prefetch(res)

    def _apply_cache_compact(self, res):
        ex = res.get("cache")
        if ex is not None and ex["count"]:
            self.cache.update_batch(ex["depths"], ex["keys"], ex["thetas"], ex["explored"])

    def _absorb_dominance_compact(self, res):
        ex = res.get("dom")
        if ex is not None and ex["count"]:
            self.dominance.insert_batch(ex["depths"], ex["dkeys"], ex["dcoords"],
                                        ex["values"])

    def _enqueue_cutset_compact(self, res, batch, relaxed):
        """Enqueue every cutset row of the compact extraction.  Returns
        False when the row cap overflowed (a cutset may not be truncated):
        the caller falls back to the plane route."""
        ex = res["cut"]
        if ex["count"] > len(ex["lanes"]):
            return False
        if ex["count"] == 0:
            return True
        lanes, layers, slots, keys = ex["lanes"], ex["layers"], ex["slots"], ex["keys"]
        values = ex["values"].astype(np.int64)
        node_ub = np.asarray([nd.ub for nd in batch], np.int64)
        ubs = np.minimum(ex["ubs"].astype(np.int64), node_ub[lanes])
        keep = ubs > self.best_lb
        in_compile_dom = "dkeys" in ex
        if in_compile_dom:
            dkeys, dcoords = ex["dkeys"], ex["dcoords"]
            keep &= ~self.dominance.is_dominated_batch(layers, dkeys, dcoords, values)
        rows = np.flatnonzero(keep)
        if len(rows) == 0:
            return True
        vals, psets = paths_batch_multi(relaxed._planes, lanes[rows], layers[rows],
                                        slots[rows], batch)
        for j, i in enumerate(rows):
            self._push_cutset_node(
                keys[i], int(layers[i]), int(values[i]), int(ubs[i]), vals[j], psets[j],
                dkeys[i] if in_compile_dom else None,
                dcoords[i] if in_compile_dom else None)
        return True

    def _push_cutset_node(self, key, depth, value, ub, path_vals, path_set,
                          dom_key, dom_coords):
        """One cutset row into the fringe; the state is rebuilt from its
        packed key (`problem.unpack`).  Without in-compile dominance
        columns (`dom_key` None) the row is probed against, and inserted
        into, the dominance store here."""
        state = self.problem.unpack(key)
        if dom_key is None:
            res = self.dominance.is_dominated_or_insert(state, key.tobytes(), depth, value)
            if res.dominated:
                return
        sub = SubProblem(
            state=state, value=value, path_vals=path_vals, path_set=path_set, ub=ub,
            depth=depth, key=np.ascontiguousarray(key, np.int32).tobytes(),
            dom_key=dom_key, dom_coords=dom_coords,
        )
        before = len(self.fringe)
        self.fringe.push(sub)
        self.open_by_layer[sub.depth] += len(self.fringe) - before

    def _process_batch(self, batch):
        """sequential.rs:329-389 vectorized over the batch."""
        widths = [max(1, self.width_heu.max_width(nd)) for nd in batch]
        chunking = (
            self.compile_chunk is not None
            and not isinstance(self.cutoff, NoCutoff)
            and self.problem.nb_variables > self.compile_chunk
        )
        if not chunking:
            return self._process_batch_fused(batch, widths)

        clock = self._clock
        clock.lap("snapshot", "restricted_s")
        cache_tab, dom_tab = self._filter_tables()
        clock.lap("compile", "restricted_s")
        restricted = self.compiler.compile_batch(
            CompilationType.RESTRICTED, batch, self.best_lb, widths,
            cache_tab=cache_tab, dom_tab=dom_tab,
            cutoff=self.cutoff, chunk_layers=self.compile_chunk,
        )
        clock.lap("extract", "restricted_s")
        self.expanded_nodes += restricted.total_expanded
        ex_r = self._extract_batch(restricted) if self._compact else None
        clock.lap("extract", "host_s")
        need_relax, widths2 = [], []
        improved = restricted.global_best > self.best_lb
        if improved and self._compact:
            restricted._planes.prefetch(self._PATH_PLANES)
        clock.lap("absorb", "host_s")
        for nd, dd, w in zip(batch, restricted, widths):
            if improved:
                self._maybe_update_best(dd)
            if not self._compact:
                self._apply_cache_updates(dd)
                self._absorb_dominance(dd)
            if not dd.is_exact():
                need_relax.append(nd)
                widths2.append(w)
        if self._compact:
            self._apply_cache_compact(ex_r)
            self._absorb_dominance_compact(ex_r)

        if not need_relax:
            return
        # refreshed snapshots: the restricted pass may have strengthened
        # both stores
        clock.lap("snapshot", "relaxed_s")
        cache_tab, dom_tab = self._filter_tables()
        clock.lap("compile", "relaxed_s")
        relaxed = self.compiler.compile_batch(
            CompilationType.RELAXED, need_relax, self.best_lb, widths2,
            cache_tab=cache_tab, dom_tab=dom_tab,
            cutoff=self.cutoff, chunk_layers=self.compile_chunk,
        )
        clock.lap("extract", "relaxed_s")
        self.expanded_nodes += relaxed.total_expanded
        ex_x = self._extract_batch(relaxed, want_cutset=True) if self._compact else None
        clock.lap("absorb", "host_s")
        self._absorb_relaxed(list(zip(need_relax, relaxed)), need_relax, relaxed, ex_x)

    def _absorb_relaxed(self, need, batch, relaxed, ex_x):
        """The relaxed pass's results: incumbent, cache and dominance rows,
        then the cutset of every inexact lane into the fringe.  `need` is
        the (node, relaxed DD) pairs to read, `batch` the nodes of all the
        lanes of `relaxed`, `ex_x` its compact extraction or None for the
        plane route."""
        improved = relaxed.global_best > self.best_lb
        for nd, dd in need:
            if improved:
                self._maybe_update_best(dd)
            if ex_x is None:
                self._apply_cache_updates(dd)
                self._absorb_dominance(dd)
                if not dd.is_exact():
                    self._enqueue_cutset(nd, dd)
        if ex_x is not None:
            self._apply_cache_compact(ex_x)
            self._absorb_dominance_compact(ex_x)
            for _, dd in need:
                dd._check_overflow()
            if not self._enqueue_cutset_compact(ex_x, batch, relaxed):
                for nd, dd in need:
                    if not dd.is_exact():
                        self._enqueue_cutset(nd, dd)

    def _process_batch_fused(self, batch, widths):
        """One superstep (engine `compile_fused`): restricted + relaxed
        back to back on the device, the relaxed pass pruning against the
        restricted pass's incumbent.  Both passes share the pre-superstep
        cache/dominance snapshots (ddo_tpu's documented divergence from
        the two-pass route: a staler snapshot only weakens pruning)."""
        clock = self._clock
        clock.lap("snapshot", "restricted_s")
        cache_tab, dom_tab = self._filter_tables()
        clock.lap("compile", "restricted_s")
        restricted, relaxed = self.compiler.compile_fused(
            batch, self.best_lb, widths, cache_tab=cache_tab, dom_tab=dom_tab)
        clock.lap("extract", "restricted_s")
        self.expanded_nodes += restricted.total_expanded + relaxed.total_expanded
        ex_r = ex_x = None
        if self._compact:
            ex_r = self._extract_batch(restricted)
            ex_x = self._extract_batch(relaxed, want_cutset=True)
        clock.lap("extract", "host_s")
        improved = restricted.global_best > self.best_lb
        if improved and self._compact:
            restricted._planes.prefetch(self._PATH_PLANES)
        clock.lap("absorb", "host_s")
        need = []
        for nd, dd_r, dd_x in zip(batch, restricted, relaxed):
            if improved:
                self._maybe_update_best(dd_r)
            if not self._compact:
                self._apply_cache_updates(dd_r)
                self._absorb_dominance(dd_r)
            if not dd_r.is_exact():
                need.append((nd, dd_x))
        if self._compact:
            self._apply_cache_compact(ex_r)
            self._absorb_dominance_compact(ex_r)
        self._absorb_relaxed(need, batch, relaxed, ex_x)

    def _maybe_update_best(self, dd):
        """sequential.rs:394-400."""
        val = dd.best_exact_value()
        if val is not None and val > self.best_lb:
            self.best_lb = val
            self.best_sol = dd.best_exact_solution()

    def _apply_cache_updates(self, dd):
        if isinstance(self.cache, EmptyCache):
            return
        self.cache.update_batch(*dd.cache_batch())

    def _absorb_dominance(self, dd):
        """Feed every live exact node to the global dominance store (the
        insertions _filter_with_dominance performs per layer, clean.rs:697)."""
        if self.filtering and self.dominance.dom is not None and "dkey" in dd.o:
            self.dominance.insert_batch(*dd.exact_nodes_batch())

    def _enqueue_cutset(self, node, dd):
        """sequential.rs:403-416, vectorized: cutset extraction, ub
        tightening and dominance probing on numpy row batches; states are
        rebuilt from the packed keys (`problem.unpack`) only for the rows
        that enter the fringe."""
        in_compile_dom = (
            self.filtering and self.dominance.dom is not None and "dkey" in dd.o
        )
        batch = dd.cutset_batch(with_dom=in_compile_dom)
        keys, depths, values, ubs, pvals, psets = batch[:6]
        if len(depths) == 0:
            return
        ubs = np.minimum(ubs, node.ub)
        keep = ubs > self.best_lb
        if in_compile_dom:
            # insertion happened in _absorb_dominance; check-only probe
            keep &= ~self.dominance.is_dominated_batch(depths, batch[7], batch[8], values)
        for i in np.flatnonzero(keep):
            self._push_cutset_node(
                keys[i], int(depths[i]), int(values[i]), int(ubs[i]), pvals[i], psets[i],
                batch[7][i] if in_compile_dom else None,
                batch[8][i] if in_compile_dom else None)

    def _abort(self, reason, pending):
        """sequential.rs:418-422 + parallel.rs:479-497 (bound recovery)."""
        self.abort_proof = reason
        for nd in pending:
            self.best_ub = min(self.best_ub, max(nd.ub, self.best_lb))
        self.fringe.clear()
        self.cache.clear()


def ParallelSolver(bundle, batch=16, **kw):
    """Frontier parallelism (parallel.rs:287) as a K-lane superstep."""
    return SequentialSolver(bundle, batch=batch, **kw)


class NativeSolver:
    """Branch-and-bound driven by the C++ host runtime (`native/`): the
    state-deduplicated fringe and the threshold cache live in C++, and the
    per-superstep host work (pops, cache updates, pushes) crosses the FFI
    as numpy batches, around the same superstep as `SequentialSolver
    (batch=K)` on `device` ("cuda" by default, raising without a card;
    "cpu" for the plain versions).  Counterpart of ddo_tpu's
    `NativeSolver` (ddo_tpu/search/solver.py:630-933); it reads the
    compiled batches by the plane route."""

    def __init__(
        self,
        bundle: ModelBundle,
        width_heu: Optional[WidthHeuristic] = None,
        buffer_width: Optional[int] = None,
        cutset_type: CutsetType = CutsetType.LAST_EXACT_LAYER,
        use_cache: bool = True,
        dominance: Optional[DominanceChecker] = None,
        cutoff: Optional[Cutoff] = None,
        batch: int = 8,
        in_compile_filtering: bool = True,
        *,
        device="cuda",
    ):
        self.bundle = bundle
        problem = bundle.problem
        self.problem = problem
        self.width_heu = width_heu or FixedWidth(max(2, problem.domain_size))
        root = root_subproblem(problem)
        W = buffer_width or max(problem.domain_size, self.width_heu.max_width(root))
        W = max(8, 1 << (int(W) - 1).bit_length())
        self.use_cache = use_cache
        self.dominance = dominance
        self.filtering = in_compile_filtering
        dom_obj = dominance.dom if (dominance is not None and in_compile_filtering) else None
        self.device = torch.device(device)
        self.compiler = DDCompiler(bundle, W, cutset_type, dominance=dom_obj,
                                   device=self.device)
        # host mirror of the C++ threshold cache feeding the in-compilation
        # snapshot tables (the C++ cache stays authoritative for must_explore)
        self._cache_tables = SimpleCache() if (use_cache and in_compile_filtering) else None
        if self._cache_tables is not None:
            self._cache_tables.initialize(problem)
        if dominance is not None and in_compile_filtering:
            dominance.prime(problem)
        self.cutoff = cutoff or NoCutoff()
        self.compile_chunk = 32 if not isinstance(self.cutoff, NoCutoff) else None
        self.batch = batch

        self._root = root
        self._root_key = np.frombuffer(root.key, np.int32)
        self.ns = NativeSearch(problem.nb_variables, int(self._root_key.shape[0]))

        self.best_lb = NEG_INF
        self.best_ub = INF
        self.best_sol = None
        self.abort_proof = None
        self.explored_count = 0
        self.expanded_nodes = 0
        self.stats = SolverStats()

    # ------------------------------------------------------------------ API
    def maximize(self) -> Completion:
        clock = self._clock = trace.Phases(self.stats)
        clock.lap("pop")
        self.ns.push_batch(self._root_key[None, :], [0], [self._root.value], [INF], [0],
                           self._root.path_vals[None, :], self._root.path_set[None, :])
        while True:
            clock.lap("pop")
            if self.cutoff.must_stop():
                self._abort()
                break
            keys, depths, values, ubs, pvals, psets, popped = self.ns.pop_batch(
                self.batch, self.best_lb)
            self.explored_count += popped
            if len(depths) == 0:
                if len(self.ns) == 0:
                    break
                continue
            self.best_ub = min(self.best_ub, max(int(ubs[0]), self.best_lb))
            if self.use_cache:
                keep = self.ns.cache_must_explore_batch(depths, keys, values)
                keys, depths, values, ubs = keys[keep], depths[keep], values[keep], ubs[keep]
                pvals, psets = pvals[keep], psets[keep]
                if len(depths) == 0:
                    continue
            subs = [SubProblem(state=self.problem.unpack(keys[i]), value=int(values[i]),
                               path_vals=pvals[i], path_set=psets[i], ub=int(ubs[i]),
                               depth=int(depths[i]))
                    for i in range(len(depths))]
            widths = [max(1, self.width_heu.max_width(s)) for s in subs]
            chunking = (self.compile_chunk is not None
                        and self.problem.nb_variables > self.compile_chunk)
            try:
                if chunking:
                    self._superstep_two_pass(subs, widths)
                else:
                    self._superstep_fused(subs, widths)
            except CutoffInterrupt:
                clock.lap("pop")
                self._abort()
                break

        clock.stop()
        if self.abort_proof is None:
            self.best_ub = self.best_lb
        return Completion(
            is_exact=self.abort_proof is None,
            best_value=self.best_lb if self.best_sol is not None else None,
        )

    def _superstep_fused(self, subs, widths):
        """Restricted and relaxed passes in one `compile_fused`."""
        clock = self._clock
        clock.lap("snapshot", "restricted_s")
        tables = self._filter_tables()
        clock.lap("compile", "restricted_s")
        restricted, relaxed = self.compiler.compile_fused(subs, self.best_lb, widths, **tables)
        clock.lap("extract", "host_s")
        self.expanded_nodes += restricted.total_expanded + relaxed.total_expanded
        improved = restricted.global_best > self.best_lb
        clock.lap("absorb", "host_s")
        need = []
        for s, dd_r, dd_x in zip(subs, restricted, relaxed):
            if improved:
                self._maybe_update_best(dd_r)
            self._absorb(dd_r)
            if not dd_r.is_exact():
                need.append((s, dd_x))
        improved = relaxed.global_best > self.best_lb
        for s, dd_x in need:
            if improved:
                self._maybe_update_best(dd_x)
            self._absorb(dd_x)
            if not dd_x.is_exact():
                self._enqueue(dd_x, s.ub)
        self.stats.supersteps += 1

    def _superstep_two_pass(self, subs, widths):
        """Chunked restricted then relaxed compiles, interruptible by the
        cutoff (`CutoffInterrupt`)."""
        clock = self._clock
        clock.lap("snapshot", "restricted_s")
        tables = self._filter_tables()
        clock.lap("compile", "restricted_s")
        restricted = self.compiler.compile_batch(
            CompilationType.RESTRICTED, subs, self.best_lb, widths, cutoff=self.cutoff,
            chunk_layers=self.compile_chunk, **tables)
        clock.lap("extract", "host_s")
        self.expanded_nodes += restricted.total_expanded
        need, widths2 = [], []
        improved = restricted.global_best > self.best_lb
        clock.lap("absorb", "host_s")
        for s, dd, w in zip(subs, restricted, widths):
            if improved:
                self._maybe_update_best(dd)
            self._absorb(dd)
            if not dd.is_exact():
                need.append(s)
                widths2.append(w)
        self.stats.supersteps += 1
        if not need:
            return
        clock.lap("snapshot", "relaxed_s")
        tables = self._filter_tables()
        clock.lap("compile", "relaxed_s")
        relaxed = self.compiler.compile_batch(
            CompilationType.RELAXED, need, self.best_lb, widths2, cutoff=self.cutoff,
            chunk_layers=self.compile_chunk, **tables)
        clock.lap("extract", "host_s")
        self.expanded_nodes += relaxed.total_expanded
        improved = relaxed.global_best > self.best_lb
        clock.lap("absorb", "host_s")
        for s, dd in zip(need, relaxed):
            if improved:
                self._maybe_update_best(dd)
            self._absorb(dd)
            if not dd.is_exact():
                self._enqueue(dd, s.ub)

    def _abort(self):
        """Abort on cutoff with bound recovery from the pending fringe
        (parallel.rs:479-497): the best pending ub caps the proved upper
        bound before the fringe is cleared."""
        self.abort_proof = Reason.CUTOFF_OCCURRED
        ubs = self.ns.pop_batch(1, NEG_INF)[3]
        if len(ubs):
            self.best_ub = min(self.best_ub, max(int(ubs[0]), self.best_lb))
        self.ns.clear()
        self.ns.cache_clear()

    def _filter_tables(self):
        if not self.filtering:
            return {}
        dev = self.compiler.device
        return dict(
            cache_tab=self._cache_tables.snapshot(dev) if self._cache_tables is not None
            else None,
            dom_tab=self.dominance.snapshot(dev) if self.dominance is not None else None)

    def set_primal(self, value, solution):
        """abstraction/solver.rs:77: warm-start the incumbent."""
        if value > self.best_lb:
            self.best_lb = value
            self.best_sol = solution

    def _maybe_update_best(self, dd):
        val = dd.best_exact_value()
        if val is not None and val > self.best_lb:
            self.best_lb = val
            self.best_sol = dd.best_exact_solution()

    def _absorb(self, dd):
        """A compiled DD's cache rows (C++ cache and its host mirror) and
        exact nodes (dominance store)."""
        if self.use_cache:
            depths, keys, thetas, explored = dd.cache_batch()
            self.ns.cache_update_batch(depths, keys, thetas, explored)
            if self._cache_tables is not None and len(depths):
                self._cache_tables.update_batch(depths, keys, thetas, explored)
        if self.dominance is not None and self.filtering and "dkey" in dd.o:
            self.dominance.insert_batch(*dd.exact_nodes_batch())

    def _enqueue(self, dd, node_ub):
        with_dom = self.dominance is not None and "dkey" in dd.o
        batch = dd.cutset_batch(with_dom=with_dom)
        keys, depths, values, ubs, pvals, psets, scores = batch[:7]
        ubs = np.minimum(ubs, node_ub)
        keep = ubs > self.best_lb
        if with_dom:
            # check-only probe: the insertions happened in _absorb
            keep &= ~self.dominance.is_dominated_batch(depths, batch[7], batch[8], values)
        elif self.dominance is not None and len(depths):
            for i in range(len(depths)):
                res = self.dominance.is_dominated_or_insert(
                    self.problem.unpack(keys[i]), keys[i].tobytes(), int(depths[i]),
                    int(values[i]))
                keep[i] &= not res.dominated
        self.ns.push_batch(keys[keep], depths[keep], values[keep], ubs[keep],
                           scores[keep].astype(np.int64), pvals[keep], psets[keep])

    # ------------------------------------------------------------ queries
    def best_value(self):
        return self.best_lb if self.best_sol is not None else None

    def best_solution(self):
        return self.best_sol

    def best_lower_bound(self):
        return self.best_lb

    def best_upper_bound(self):
        return self.best_ub

    def gap(self) -> float:
        ub, lb = self.best_ub, self.best_lb
        if ub >= INF or lb <= NEG_INF:
            return 1.0
        u, l = max(abs(ub), abs(lb)), min(abs(ub), abs(lb))
        return (u - l) / u if u else 0.0

    def explored(self):
        return self.explored_count
