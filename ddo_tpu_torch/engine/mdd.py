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
    with a per-lane effective width (clean.rs:802-876); what follows it
    (the edge remap, the merged node, the next layer and its within-layer
    dominance) is kernel K3 on the GPU (engine/layer_tail.py);
  * edges are stored outbound, flat [K, n, W*D] (child slot, cost, valid),
    and the local bounds (clean.rs:448-475) and thresholds
    (clean.rs:478-532) come from one fused backward sweep (kernel K2 on
    the GPU, engine/backward.py);
  * exactness/cutset bookkeeping (NodeFlags, node_flags.rs:48-63) is
    parallel boolean planes.

The layer loop is a Python loop over layers; every per-lane decision in it
(is this the root layer, which variable to branch on, does the layer
overflow its width, relax or not) stays a [K] device tensor combined with
`torch.where`, so a compile makes no host round trip.  The layer index
itself is a device tensor that the body advances, and the body updates
its buffers in place (`_Layers`), so every layer runs the same body: on
a card, replayed from CUDA graphs captured once per compile shape.  With a dynamic
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

import collections
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ddo_tpu_torch.core.problem import ModelBundle, Problem
from ddo_tpu_torch.core.types import CompilationType, CutsetType, SubProblem, host_batch
from ddo_tpu_torch.engine import backward as bwd
from ddo_tpu_torch.engine import extract, layer_tail
from ddo_tpu_torch.ops import segments as seg
from ddo_tpu_torch.ops import sort as sort_ops
from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import INF, NEG_INF, argmax_first, sat_add

I32 = torch.int32


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


def _sort(ops, num_keys, out=None):
    # K1 reads strided operands: no copy beyond the int32 casts; `out`
    # takes its output
    return sort_ops.multi_sort([o.to(I32) for o in ops], num_keys, out=out)


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
    `finalize_kernel` (ddo_tpu/engine/mdd.py:1044-1060).

    On a card the layer loop replays CUDA graphs (`_Layers`).  While a
    profiler records, the call is the span `ddo.compile.<type>`, each
    iteration of its layer loop run eagerly the spans `ddo.layer.<phase>`
    of its sections, each replayed one the span `ddo.layer.replay`
    (after `ddo.layer.capture` where it captures), and `finalize` the
    span `ddo.finalize` (`utils/trace.py`)."""
    trace.count("layers", spec.bundle.problem.nb_variables - start)
    with trace.laps(_COMPILE_SPANS[spec.comp_type]) as lap:
        return _compile_lanes(spec, datas, order, root_states, root_values, root_depths,
                              best_lb, eff_width, root_path_sets, cache_tab, dom_tab,
                              cutoff, chunk_layers, start, lap)


_COMPILE_SPANS = {ct: "ddo.compile." + ct.name.lower() for ct in CompilationType}


def _compile_lanes(spec, datas, order, root_states, root_values, root_depths, best_lb,
                   eff_width, root_path_sets, cache_tab, dom_tab, cutoff, chunk_layers,
                   start, lap):
    """`compile_lanes`, with `lap` (`trace.laps`) marking its sections."""
    n = spec.bundle.problem.nb_variables
    device = root_values.device
    if order is not None:
        order = (order.to(device=device, dtype=torch.long) if torch.is_tensor(order)
                 else trace.wait(torch.as_tensor, np.asarray(order), dtype=torch.long,
                                 device=device))
    inputs = dict(datas=datas, order=order, root_states=root_states,
                  root_values=root_values, root_depths=root_depths, best_lb=best_lb,
                  eff_width=torch.clamp(eff_width, 1, spec.width),
                  root_path_sets=root_path_sets if order is None else None,
                  cache_tab=cache_tab, dom_tab=dom_tab)
    layers = _layers(spec, inputs, start)

    def poll(i):
        lap()  # a poll is in no layer's span
        if device.type == "cuda" and i > start:
            trace.wait(torch.cuda.synchronize, device)  # bound the device work queued
        if cutoff.must_stop():
            raise CutoffInterrupt()

    chunked = bool(chunk_layers) and cutoff is not None and n > chunk_layers
    for i in range(start, n):
        if chunked and (i - start) % chunk_layers == 0:
            poll(i)
        layers.run(i == n - 1, lap)
    if chunked:
        poll(n)
    lap("ddo.finalize")
    var_of, P, lel, expanded, overflow = layers.kept()
    return finalize(spec, datas, var_of, layers.cur, P, layers.E, lel, expanded, overflow,
                    best_lb, root_depths, layers.use_dom)


# ------------------------------------------------------------ layer graphs
#: compile shapes (`graph_key`) whose layers a card replays from CUDA
#: graphs, least recently used first.  Each holds its buffers and a
#: memory pool about one eager layer's peak, one for the restricted and
#: one for the relaxed pass of each lane count, so a search whose lane
#: count changes from superstep to superstep keeps those of its last few
#: counts and not a pool per count it has met
GRAPH_CACHE_SIZE = 8
_GRAPHS = collections.OrderedDict()
#: the entry of a shape whose layer body waits on the host: it runs eagerly
_EAGER = "eager"
_SIDE_STREAMS = {}

#: what the carried layer, the [K, n+1, W] planes and the [K, n, C]
#: edges hold; a buffer starts each compile filled with `_FILL` (0 or
#: False where absent): the planes' neutral fill below the first layer run
_CARRY = ("state", "val", "mask", "exact", "relaxed", "bp", "bd", "bs", "ebp", "wlp", "wlth")
_PLANES = ("state", "val", "mask", "exact", "relaxed", "rub", "bp", "bd", "bs", "wlp", "wlth")
_EDGES = ("child", "cost", "valid")
_FILL = dict(val=NEG_INF, rub=INF, bp=-1, wlth=INF, eptheta=INF, child=-1)
_BOOLS = {"mask", "exact", "relaxed", "bs", "ebp", "wlp", "hic", "valid"}


def _tree(fn, tree, *rest):
    """`fn` on each tensor leaf of a tree of dicts, tuples and lists (and
    on the matching leaves of `rest`); other leaves stay as they are."""
    if isinstance(tree, dict):
        return {k: _tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(fn, v, *(r[j] for r in rest)) for j, v in enumerate(tree))
    return fn(tree, *rest) if torch.is_tensor(tree) else tree


def _signature(tree):
    """The structure of a tree with each tensor leaf's shape and dtype and
    each other leaf's value."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _signature(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (tuple, list)):
        return ("seq",) + tuple(_signature(v) for v in tree)
    return ("tensor", tuple(tree.shape), tree.dtype) if torch.is_tensor(tree) else tree


def graph_key(spec: DDSpec, inputs) -> tuple:
    """What fixes a compile's layer body, and so keys its graphs: the
    model's, relaxation's, ranking's and dominance's classes (which fix
    long arcs), the compilation type, n, W, D, the shape and dtype of
    every input leaf (`_compile_lanes`' `inputs`: K, the roots, the
    model's data, the order, each filter table and its length, with None
    where one is absent, which also gives a dynamic order and each
    table's flag) and the device; never an object's identity, since every
    solve brings a new instance with new tensors.  The entry under a key
    holds the middle layers' graphs apart from the last layer's
    (`is_last`), whose body differs."""
    b = spec.bundle
    return (type(b.problem), type(b.relaxation), type(b.ranking), type(spec.dominance),
            spec.comp_type, b.problem.nb_variables, spec.width, b.problem.domain_size,
            _signature(inputs), str(inputs["root_values"].device))


def _layers(spec, inputs, start):
    """The `_Layers` of one compile, begun at layer `start`: on a card the
    kept ones of its shape, loaded with `inputs`; fresh ones, run
    eagerly, on the CPU and for a shape whose body waits on the host."""
    layers = _EAGER
    if inputs["root_values"].is_cuda:
        key = graph_key(spec, inputs)
        layers = _GRAPHS.get(key)
        if layers is None:
            layers = _GRAPHS[key] = _Layers(spec, inputs, key)
            while len(_GRAPHS) > GRAPH_CACHE_SIZE:
                _GRAPHS.popitem(last=False)
        else:
            _GRAPHS.move_to_end(key)
            if layers is not _EAGER:
                layers.load(inputs)
    if layers is _EAGER:
        layers = _Layers(spec, inputs)
    layers.begin(start)
    return layers


def _no_lap(name=None):
    pass


_put = layer_tail.put


class _Layers:
    """The layer loop of one compile shape: the buffers its body reads and
    writes, and the body, cut into three segments at K1's two sorts.

    The body reads the layer index `i`, an int64 0-d tensor on the
    compile device, and the compile's inputs `inp`, and updates in place
    the carried layer `cur`, the planes `P`, the edges `E`, `lel`,
    `expanded` and `overflow` (and under a dynamic order `var_of` and
    `assigned`), then advances `i`: one body serves every layer.  Fresh
    `_Layers` run it eagerly.  Kept ones (a card's, under `key`) copy each
    compile's inputs into their own (`load`) and run the first layer of
    each kind, a middle one and the last one, eagerly, which loads every
    kernel; the next layer of that kind captures the body as three CUDA
    graphs in one memory pool, replayed for every later one, with K1
    called eagerly between them into `sorted`, the input of the next
    graph.  A body that waits on the host cannot be captured: the capture
    is given up (`trace.CaptureRefused`), and that compile and every later
    one of its shape run eagerly.  `kept` copies out the buffers a
    compile's result keeps, which a later compile of the shape
    overwrites."""

    def __init__(self, spec, inputs, key=None):
        problem, dom = spec.bundle.problem, spec.dominance
        self.spec, self.key = spec, key
        self.inp = inp = _tree(torch.clone, inputs) if key is not None else inputs
        device = self.device = inp["root_values"].device
        K = self.K = inp["root_values"].shape[0]
        n, W, D = self.n, self.W, self.D = problem.nb_variables, spec.width, problem.domain_size
        C = self.C = W * D
        self.use_dom = dom is not None and dom.key_cols(inp["root_states"]) is not None
        self.use_dom_snap = self.use_dom and inp["dom_tab"] is not None
        self.filtering = inp["cache_tab"] is not None or self.use_dom_snap
        self.long_arcs = has_long_arcs(problem)
        self.dynamic_order = inp["order"] is None

        empty = lambda shape, dtype=I32: torch.empty(shape, dtype=dtype, device=device)
        self.idxs = torch.arange(C, dtype=I32, device=device)
        self.neg_idxs = (-self.idxs).expand(K, C)
        self.slot0 = torch.arange(D, device=device) == 0
        self.i = empty((), torch.long)
        self.i1 = self.i.view(1)
        # the root layer as a [K, W] row (slot 0)
        self.r_state = tmap(lambda x: x[:, None].expand((K, W) + tuple(x.shape[1:])),
                            inp["root_states"])
        self.r_val = empty((K, W))
        self.r_mask = torch.zeros((K, W), dtype=torch.bool, device=device)
        self.r_mask[:, 0] = True

        def bufs(names, lead):
            return {k: tmap(lambda x: empty(lead + tuple(x.shape[1:]), x.dtype),
                            inp["root_states"]) if k == "state"
                    else empty(lead, torch.bool if k in _BOOLS else I32) for k in names}

        self.cur = bufs(_CARRY, (K, W))
        self.P = {**bufs(_PLANES, (K, n + 1, W)), **bufs(("eptheta", "hic"), (K, n, W))}
        self.E = bufs(_EDGES, (K, n, C))
        self.lel, self.expanded = empty((K,)), empty((K,))
        self.overflow = empty((K,), torch.bool)
        if self.dynamic_order:
            self.var_of, self.assigned = empty((K, n)), empty((K, n), torch.bool)
        self.graphs, self.warm, self.refused = {}, set(), False
        self.sorted = [None, None]  # kept ones: K1's output of each sort
        if key is not None:
            self.pool = torch.cuda.graph_pool_handle()

    def load(self, inputs):
        """Copy a compile's inputs into the kept ones."""
        _tree(lambda dst, src: dst.copy_(src), self.inp, inputs)

    def begin(self, start):
        """Every buffer as it stands before layer `start`."""
        for group in (self.cur, self.P, self.E):
            for k, v in group.items():
                fill = _FILL.get(k, 0)
                tmap(lambda x: x.fill_(fill), v)
        self.lel.fill_(self.n + 1)
        self.expanded.zero_()
        self.overflow.zero_()
        if self.dynamic_order:
            self.var_of.zero_()
            self.assigned.copy_(self.inp["root_path_sets"])
        else:
            self.var_of = self.inp["order"].to(I32).expand(self.K, self.n)
        self.r_val.fill_(NEG_INF)
        self.r_val[:, 0] = self.inp["root_values"]
        self.i.fill_(start)

    def kept(self):
        """(var_of, P, lel, expanded, overflow) for `finalize`: copies of
        the kept buffers, which a later compile of the shape overwrites.
        (`cur` and `E` are only read, before any later compile.)"""
        if self.key is None:
            return self.var_of, self.P, self.lel, self.expanded, self.overflow
        var_of = self.var_of.clone() if self.dynamic_order else self.var_of
        return (var_of, {k: tmap(torch.clone, v) for k, v in self.P.items()},
                self.lel.clone(), self.expanded.clone(), self.overflow.clone())

    # ------------------------------------------------------------- a layer
    def run(self, is_last, lap):
        """One layer: eagerly, or from this shape's graphs of its kind."""
        if self.key is None or self.refused:
            return self._eager(is_last, lap)
        graphs = self.graphs.get(is_last)
        if graphs is None:
            if is_last not in self.warm:
                self.warm.add(is_last)
                return self._eager(is_last, lap)
            lap("ddo.layer.capture")
            graphs = self._capture(is_last)
            if graphs is None:
                return self._eager(is_last, lap)
        lap("ddo.layer.replay")
        self._replay(*graphs)

    def _eager(self, is_last, lap):
        ops1, nk1, c = self._seg1(is_last, lap)
        s1 = _sort(ops1, nk1, self._sorted(0, ops1))
        ops2, nk2, c = self._seg2(is_last, s1, c, lap)
        s2 = _sort(ops2, nk2, self._sorted(1, ops2))
        self._seg3(is_last, s2, c, lap)

    def _sorted(self, j, ops):
        """K1's output buffer of sort j (kept `_Layers` only)."""
        if self.key is not None and self.sorted[j] is None:
            self.sorted[j] = torch.empty((len(ops),) + tuple(ops[0].shape), dtype=I32,
                                         device=self.device)
        return self.sorted[j]

    def _graph(self, body):
        """`body()` captured as a CUDA graph in this shape's pool: the graph,
        what body returned (tensors the graph writes on replay) and the
        tally of what the capture counted (`trace.tally`)."""
        graph = torch.cuda.CUDAGraph()
        with trace.tally() as tally:
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = body()
            finally:
                graph.capture_end()
        return graph, out, tally

    def _capture(self, is_last):
        """The three graphs of a layer of this kind, or None where the body
        waits on the host (this shape then runs eagerly)."""
        dev = self.device
        if dev not in _SIDE_STREAMS:
            _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
        side, stream = _SIDE_STREAMS[dev], torch.cuda.current_stream(dev)
        side.wait_stream(stream)
        try:
            with torch.cuda.stream(side):
                g1, (ops1, nk1, c), t1 = self._graph(lambda: self._seg1(is_last, _no_lap))
                s1 = self.sorted[0].unbind(0)
                g2, (ops2, nk2, c), t2 = self._graph(
                    lambda: self._seg2(is_last, s1, c, _no_lap))
                s2 = self.sorted[1].unbind(0)
                g3, _, t3 = self._graph(lambda: self._seg3(is_last, s2, c, _no_lap))
        except trace.CaptureRefused:
            self.refused = True
            _GRAPHS[self.key] = _EAGER
            return None
        finally:
            stream.wait_stream(side)
        trace.count("graph_captures", 3)
        # `counts` what a replay of the three counts; `c` every tensor the
        # graphs pass on, kept for their lifetime
        counts = t1 + t2 + t3 + collections.Counter(graph_replays=3, graph_layers=1)
        self.graphs[is_last] = (g1, ops1, nk1, g2, ops2, nk2, g3, counts, c)
        return self.graphs[is_last]

    def _replay(self, g1, ops1, nk1, g2, ops2, nk2, g3, counts, c):
        g1.replay()
        _sort(ops1, nk1, self.sorted[0])
        g2.replay()
        _sort(ops2, nk2, self.sorted[1])
        g3.replay()
        trace.replayed(counts)

    # ----------------------------------------------------- the body, in three
    def _full(self, shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def _false(self, shape):
        return torch.zeros(shape, dtype=torch.bool, device=self.device)

    def _seg1(self, is_last, lap):
        """The layer's root merge, branching variable, rough bounds and
        expansion; returns sort-1's operands (`sort_operands`), its key
        count and what the next segment reads."""
        lap("ddo.layer.rub")
        spec, inp, cur, i = self.spec, self.inp, self.cur, self.i
        problem, rlx = spec.bundle.problem, spec.bundle.relaxation
        pdata, rdata, kdata = inp["datas"]
        K, W, D, C = self.K, self.W, self.D, self.C

        # root layer materializes at depth `root_depth` (clean.rs:383-405)
        is_root = (inp["root_depths"] == i)[:, None]  # [K, 1]
        c_state = tmap(lambda r, x: torch.where(_bcast(is_root, x), r, x),
                       self.r_state, cur["state"])
        c_val = torch.where(is_root, self.r_val, cur["val"])
        c_mask = torch.where(is_root, self.r_mask, cur["mask"])
        c_exact = torch.where(is_root, self.r_mask, cur["exact"])
        c_relaxed = cur["relaxed"] & ~is_root
        c_bp = torch.where(is_root, -1, cur["bp"])
        c_bd = torch.where(is_root, 0, cur["bd"])
        c_bs = cur["bs"] & ~is_root
        c_ebp = torch.where(is_root, self.r_mask, cur["ebp"])
        c_wlp = cur["wlp"] & ~is_root
        c_wlth = torch.where(is_root, INF, cur["wlth"])
        flat_state = _flat(c_state, 2)

        # the branched variable, one per lane: int64 [K]
        if self.dynamic_order:
            var = problem.next_variable(pdata, i, c_state, c_mask, self.assigned).long()
            _put(self.var_of, self.i1, var)
            col = var[:, None]
            self.assigned.scatter_(
                1, col, self.assigned.gather(1, col) | c_mask.any(dim=1, keepdim=True))
        else:
            var = inp["order"].index_select(0, self.i1).expand(K)
        var_b = var.repeat_interleave(W)

        # --- RUB pruning (clean.rs:360-365) --------------------------------
        rub = torch.where(c_mask, rlx.rub(rdata, flat_state, i).view(K, W), INF)
        expand_ok = c_mask & (sat_add(c_val, rub) > inp["best_lb"][:, None])
        if self.long_arcs:
            # only the impacted rows really branch here
            imp = problem.is_impacted_by(pdata, flat_state, var_b)  # [K*W]
            self.expanded += (expand_ok & imp.view(K, W)).sum(dim=1, dtype=I32)
        else:
            self.expanded += expand_ok.sum(dim=1, dtype=I32)

        # --- expansion of K*W rows x D slots --------------------------------
        lap("ddo.layer.expand")
        nstate, cost, dval, valid = problem.step(pdata, flat_state, var_b, i)
        f_skip = None
        if self.long_arcs:
            # an unimpacted row: one identity candidate at domain slot 0
            keep = imp[:, None]  # [K*W, 1]
            valid = torch.where(keep, valid, self.slot0)
            nstate = tmap(lambda real, x: torch.where(
                _bcast(keep, real), real, x[:, None]), nstate, flat_state)
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
        lap("ddo.layer.dedup")
        f_keys = _cols(problem.pack, f_state, (K, C))  # [K, C, Kk]
        Kk = f_keys.shape[2]
        key_ops = [(~f_valid).to(I32)] + [f_keys[:, :, k] for k in range(Kk)] \
            + [-f_val, self.neg_idxs]
        f_rank = _cols(lambda s: spec.bundle.ranking.score(kdata, s), f_state, (K, C))
        R = f_rank.shape[2]
        pay = [f_dval, f_pexact.to(I32)] + ([f_skip.to(I32)] if self.long_arcs else []) \
            + [f_rank[:, :, r] for r in range(R)]
        f_dkey = f_dcoord = None
        if self.use_dom:
            f_dkey = _cols(spec.dominance.key_cols, f_state, (K, C))
            f_dcoord = _cols(spec.dominance.coord_cols, f_state, (K, C))
            pay += [f_dkey[:, :, k] for k in range(f_dkey.shape[2])]
            pay += [f_dcoord[:, :, k] for k in range(f_dcoord.shape[2])]
        return [o.to(I32) for o in key_ops + pay], len(key_ops), dict(
            c_state=c_state, c_val=c_val, c_mask=c_mask, c_exact=c_exact,
            c_relaxed=c_relaxed, c_bp=c_bp, c_bd=c_bd, c_bs=c_bs, c_ebp=c_ebp, c_wlp=c_wlp,
            c_wlth=c_wlth, rub=rub, var=var, f_valid=f_valid, f_cost=f_cost, f_dval=f_dval,
            f_state=f_state, f_skip=f_skip, f_dkey=f_dkey, f_dcoord=f_dcoord, Kk=Kk, R=R)

    def _next_row(self, table):
        """Row i + 1 of an [n+1, ...] filter table."""
        return table.index_select(0, self.i1 + 1).squeeze(0)

    def _seg2(self, is_last, s1, c, lap):
        """Sort-1's runs (dedup), the filter tables and the restrict/relax
        decision; returns sort-2's operands, its key count and what the
        last segment reads."""
        spec, inp, i = self.spec, self.inp, self.i
        comp, dom = spec.comp_type, spec.dominance
        K, W, C, idxs = self.K, self.W, self.C, self.idxs
        Kk, R = c["Kk"], c["R"]
        full, false = self._full, self._false

        kv = torch.stack(s1[1 : 1 + Kk], dim=2)
        perm = -s1[2 + Kk]
        valid_s = s1[0] == 0
        val_s = torch.where(valid_s, -s1[1 + Kk], NEG_INF)
        o = 3 + Kk
        pexact_s = s1[o + 1].bool()
        o += 2
        skip_s = None
        if self.long_arcs:
            skip_s = s1[o].bool()
            o += 1
        s_rank = torch.stack(s1[o : o + R], dim=2)
        o += R
        if self.use_dom:
            KK, CC = c["f_dkey"].shape[2], c["f_dcoord"].shape[2]
            s_dkey = torch.stack(s1[o : o + KK], dim=2) if KK else c["f_dkey"]
            s_dcoord = torch.stack(s1[o + KK : o + KK + CC], dim=2) if CC else c["f_dcoord"]

        first = torch.ones((K, C), dtype=torch.bool, device=self.device)
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
        lap("ddo.layer.filter")
        pruned = false((K, C))
        ptheta = full((K, C), INF)
        pci = false((K, C))
        if inp["cache_tab"] is not None and not is_last:
            tk, tv, tm = (self._next_row(inp["cache_tab"][x]) for x in ("keys", "vals", "valid"))
            eq = (kv[:, :, None, :] == tk[None, None]).all(dim=3) & tm
            cth = torch.where(eq, tv, NEG_INF).amax(dim=2)
            pc = head & eq.any(dim=2) & (val_s <= cth)
            pruned |= pc
            ptheta = torch.where(pc, torch.minimum(ptheta, cth), ptheta)
            # parents of a cache-pruned INEXACT node join the frontier
            # cutset (clean.rs:586-606 visits pruned nodes too)
            pci = pc & ~slot_exact
        if self.use_dom_snap and not is_last:
            dk, dc, dv, dm = (self._next_row(inp["dom_tab"][x])
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
        lap("ddo.layer.squash")
        eff_width = inp["eff_width"]
        cap = torch.full_like(eff_width, W) if is_last else eff_width
        no = false((K,))
        need_restrict = (U > cap) if comp == CompilationType.RESTRICTED else no
        need_relax = ((U > cap) & (i + 1 - inp["root_depths"] >= 2)) \
            if comp == CompilationType.RELAXED else no

        # promising first, pruned/invalid last
        q_keys = [(~surv).to(I32), -val_s] + [-s_rank[:, :, r] for r in range(R)] \
            + [self.neg_idxs]
        return [o.to(I32) for o in q_keys], len(q_keys), dict(
            c, kv=kv, perm=perm, val_s=val_s, skip_s=skip_s, head=head,
            slot_exact=slot_exact, pruned=pruned, ptheta=ptheta, pci=pci, surv=surv, U=U,
            cap=cap, need_restrict=need_restrict, need_relax=need_relax)

    def _seg3(self, is_last, s2, c, lap):
        """The kept, merged and pruned nodes from sort-2, the edge remap, the
        next layer and its within-layer dominance: writes layer i into the
        planes and edges, the next layer into the carry, and advances i.
        Kernel K3's three parts (`layer_tail`) with the model's hooks
        between them."""
        spec, inp, i, i1, P = self.spec, self.inp, self.i, self.i1, self.P
        problem, rlx = spec.bundle.problem, spec.bundle.relaxation
        K, W, D, C = self.K, self.W, self.D, self.C
        f_state, c_state = c["f_state"], c["c_state"]
        t = {k: c[k] if c[k] is None else c[k].contiguous() for k in _TAIL_INPUTS}
        t.update(neg_order=s2[-1], so_key=s2[0], so_negval=s2[1])
        a = layer_tail.remap(t)

        # merged node (only meaningful under need_relax)
        rdata = inp["datas"][1]
        merged_state = rlx.merge(rdata, f_state, a.f_mmask)
        merged_key = problem.pack(merged_state).to(I32).contiguous()  # [K, Kk]
        rcost = None
        if spec.comp_type == CompilationType.RELAXED:
            # src is the parent's state, dst the original child state
            # (Relaxation::relax, abstraction/dp.rs:93-100)
            rcost = rlx.relax_cost(
                rdata, _flat(tmap(lambda x: x.repeat_interleave(D, dim=1), c_state), 2),
                _flat(f_state, 2),
                _flat(tmap(lambda m: m[:, None].expand((K, C) + tuple(m.shape[1:])),
                           merged_state), 2),
                c["f_dval"].reshape(-1), c["f_cost"].reshape(-1), c["var"].repeat_interleave(C),
            ).to(I32).reshape(K, C).contiguous()

        # --- materialize the next layer: the first W ranking-sorted slots,
        # through the composition of the two sort permutations
        lap("ddo.layer.materialize")
        layer = {name: c["rub" if name == "rub" else "c_" + name]
                 for name in layer_tail.NODE_PLANES}
        planes = P if self.filtering else dict(P, eptheta=None)
        nxt = layer_tail.edges(i, t, a, merged_key, rcost, layer, planes, self.E, self.lel,
                               self.overflow)
        tmap(lambda p, v: _put(p, i1, v), P["state"], c_state)
        nl_state = tmap(lambda x: seg.take_rows(x, nxt.fidx), f_state)
        nl_state = tmap(lambda m, x: torch.where(_bcast(nxt.fresh, x), m[:, None], x),
                        merged_state, nl_state)
        tmap(lambda dst, src: dst.copy_(src), self.cur["state"], nl_state)

        # ---- within-layer dominance (clean.rs:689-708, the layer-local
        # part), the carried layer, and i advanced
        lap("ddo.layer.dominance")
        dom = spec.dominance
        w_dkey = w_dcoord = None
        if self.use_dom and not is_last:
            w_dkey = _cols(dom.key_cols, nl_state, (K, W)).contiguous()
            w_dcoord = _cols(dom.coord_cols, nl_state, (K, W)).contiguous()
        layer_tail.dominance(i, nxt, w_dkey, w_dcoord, dom is not None and dom.use_value,
                             c["c_ebp"], self.cur)


#: what `_seg3` hands K3 of the earlier segments' tensors
_TAIL_INPUTS = ("surv", "head", "perm", "pruned", "pci", "ptheta", "cap", "need_relax",
                "need_restrict", "U", "kv", "val_s", "slot_exact", "skip_s", "f_valid",
                "f_cost", "f_dval", "f_skip")


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
            self._np[key] = tmap(lambda t: trace.wait(t.cpu).numpy(), self._dev[key])
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
        return trace.wait(int, self._gbest)

    @property
    def total_expanded(self) -> int:
        """Sum of node expansions across active lanes."""
        return trace.wait(int, self._texp)


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
        copy = lambda x, dtype=None: trace.wait(torch.as_tensor, x, dtype=dtype, device=dev)
        t = lambda x: copy(np.asarray(x), I32)
        first = subs[0].state
        if isinstance(first, dict):
            states = {k: copy(np.stack([np.asarray(s.state[k]) for s in subs])) for k in first}
        else:
            states = copy(np.stack([np.asarray(s.state) for s in subs]))
        K = len(subs)
        lb = best_lb.expand(K) if torch.is_tensor(best_lb) else t(best_lb).expand(K)
        psets = copy(np.stack([np.asarray(s.path_set, bool) for s in subs]))
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
