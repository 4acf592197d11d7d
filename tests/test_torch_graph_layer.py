"""The compile's layer loop as one body over device buffers, replayed on a
card from CUDA graphs (ddo_tpu_torch/engine/mdd.py `_Layers`).

On the CPU: every model's depth-taking hooks give the same results for a
Python int depth and for the engine's int64 0-d tensor depth; `trace.wait`
refuses to wait while a stream captures; the graph key names what fixes a
layer body and nothing of an instance's identity; the benchmark's
`graph_layer_pct` reader.  On an NVIDIA GPU (marked `cuda`, skipped
without one): two instances of equal shapes compiled back to back, the
second replayed, give every plane of the CPU path, for all twelve models;
a live batch survives a later compile of its shape; a replayed compile
makes no host sync.  This file imports neither jax nor ddo_tpu; on the
card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_graph_layer.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu_torch as tt
from ddbench import cell as cells
from ddo_tpu_torch.core.problem import depth_row, depth_select
from ddo_tpu_torch.engine import layer_tail, mdd
from ddo_tpu_torch.models import alp, golomb, knapsack, lcs, max2sat, mcp, misp, psp, sop
from ddo_tpu_torch.models import srflp, talentsched, tsptw
from ddo_tpu_torch.search.solver import SolverStats
from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import NEG_INF

B = 12  # walkers of a rollout


#: name -> (instance of a seed, relaxation, ranking of an instance,
#: dominance model or None); every seed gives the same shapes
SPECS = {
    "knapsack": (lambda s: knapsack.generate_uncorrelated(9, 100, 3, 10, seed=s),
                 knapsack.KPRelax, lambda pb: knapsack.KPRanking(), knapsack.KPDominance),
    "misp": (lambda s: misp.generate_gnp(9, 0.3, seed=s)[0], misp.MispRelax,
             misp.MispRanking, None),
    "max2sat": (lambda s: max2sat.generate_random(7, 14, seed=s)[0], max2sat.Max2SatRelax,
                lambda pb: max2sat.Max2SatRanking(), None),
    "mcp": (lambda s: mcp.generate_random(7, 0.5, seed=s)[0], mcp.McpRelax,
            lambda pb: mcp.McpRanking(), None),
    "golomb": (lambda s: golomb.Golomb(5), golomb.GolombRelax,
               lambda pb: golomb.GolombRanking(), None),
    "talentsched": (lambda s: talentsched.generate_random(6, 3, seed=s),
                    talentsched.TalentSchedRelax, lambda pb: talentsched.TalentSchedRanking(),
                    None),
    "tsptw": (lambda s: tsptw.generate_random(7, seed=s, window=100.0), tsptw.TsptwRelax,
              lambda pb: tsptw.TsptwRanking(), tsptw.TsptwDominance),
    "sop": (lambda s: sop.generate_random(7, seed=s, p_prec=0.15), sop.SopRelax,
            lambda pb: sop.SopRanking(), None),
    "srflp": (lambda s: srflp.generate_random(6, seed=s), srflp.SrflpRelax,
              lambda pb: srflp.SrflpRanking(), None),
    "lcs": (lambda s: lcs.generate_random(3, 4, 8, seed=s), lcs.LcsRelax,
            lambda pb: lcs.LcsRanking(), lcs.LcsDominance),
    "psp": (lambda s: psp.generate_random(8, 3, seed=s), psp.PspRelax,
            lambda pb: psp.PspRanking(), None),
    "alp": (lambda s: alp.generate_random(8, 2, 1, seed=s), alp.AlpRelax,
            lambda pb: alp.AlpRanking(), alp.AlpDominance),
}


def model(name, seed):
    """(bundle, dominance model or None) of the seed's instance."""
    make, relax, ranking, dom = SPECS[name]
    pb = make(seed)
    return tt.ModelBundle(pb, relax(pb), ranking(pb)), dom() if dom else None


#: the models whose layer body waits on the host (a run of eager layers)
WAITING = {"mcp", "sop"}


def _equal(a, b, msg):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), msg
        for k in a:
            _equal(a[k], b[k], f"{msg} {k}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), msg


def _rollout(pb, data):
    """[(depth, states [B, ...], var [B], assigned [B, n])]: B random walks
    of the model's own `step` from the root (a walker with no valid slot
    stays), so every state is reachable."""
    rng = np.random.default_rng(5)
    n = pb.nb_variables
    st = {k: torch.as_tensor(np.stack([np.asarray(v)] * B))
          for k, v in pb.initial_state().items()}
    order = pb.var_order()
    assigned = np.zeros((B, n), bool)
    rows = np.arange(B)
    out = []
    for depth in range(n):
        if order is None:
            var = np.asarray([rng.choice(np.flatnonzero(~assigned[b])) for b in range(B)])
        else:
            var = np.full(B, order[depth])
        out.append((depth, st, torch.as_tensor(var), torch.as_tensor(assigned.copy())))
        nstate, _, _, valid = pb.step(data, st, torch.as_tensor(var), depth)
        valid = valid.numpy()
        pick = np.asarray([rng.choice(np.flatnonzero(valid[b])) if valid[b].any() else -1
                           for b in range(B)])
        moved = torch.as_tensor(pick >= 0)
        st = {k: torch.where(moved.reshape((B,) + (1,) * (st[k].dim() - 1)),
                             nstate[k][rows, np.maximum(pick, 0)], st[k]) for k in st}
        assigned[rows, var] = True
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_hooks_take_a_device_depth(name):
    """`step`, `Relaxation.rub` and (under a dynamic order)
    `next_variable` at the first, a middle and the last layer: equal, in
    value and dtype, for a Python int depth and an int64 0-d tensor."""
    bundle, _ = model(name, 0)
    pb = bundle.problem
    data, rdata = pb.data("cpu"), bundle.relaxation.data("cpu")
    layers = _rollout(pb, data)
    n = pb.nb_variables
    for depth, st, var, assigned in (layers[0], layers[n // 2], layers[-1]):
        d = torch.tensor(depth)
        for got, ref in zip(pb.step(data, st, var, d), pb.step(data, st, var, depth)):
            _equal(got, ref, f"{name} step at depth {depth}")
        _equal(bundle.relaxation.rub(rdata, st, d), bundle.relaxation.rub(rdata, st, depth),
               f"{name} rub at depth {depth}")
        if pb.var_order() is None:
            states = {k: v.reshape((3, B // 3) + tuple(v.shape[1:])) for k, v in st.items()}
            mask = torch.ones((3, B // 3), dtype=torch.bool)
            _equal(pb.next_variable(data, d, states, mask, assigned[::B // 3]),
                   pb.next_variable(data, depth, states, mask, assigned[::B // 3]),
                   f"{name} next_variable at depth {depth}")


def test_depth_helpers():
    t = torch.arange(10, 20, dtype=torch.int32)
    assert depth_row(t, 3) == 13 and depth_row(t, torch.tensor(3)).shape == ()
    assert depth_row(t, torch.tensor(3)) == 13
    a, b = torch.zeros(4), torch.ones(4)
    assert depth_select(True, a, b) is a and depth_select(False, a, b) is b
    assert torch.equal(depth_select(torch.tensor(5) == 5, a, b), a)
    assert torch.equal(depth_select(torch.tensor(5) == 4, a, b), b)


def test_wait_refuses_only_while_capturing(monkeypatch):
    """`trace.wait` calls and counts outside a capture; while the current
    stream captures (faked here) it raises `CaptureRefused`, calls nothing
    and counts nothing."""
    calls = []
    before = trace.counted("host_syncs")
    assert trace.wait(calls.append, 1) is None and calls == [1]
    assert trace.counted("host_syncs") == before + 1
    assert not trace.capturing()  # no CUDA initialized: the driver is not asked
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert not trace.capturing()
    trace.wait(calls.append, 2)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert trace.capturing()
    with pytest.raises(trace.CaptureRefused, match="append"):
        trace.wait(calls.append, 3)
    assert calls == [1, 2] and trace.counted("host_syncs") == before + 2


def _inputs(bundle, dom, K=2, W=8, tables=False):
    """The inputs `_compile_lanes` keys its graphs on, for K root lanes on
    the CPU."""
    pb = bundle.problem
    c = tt.DDCompiler(bundle, W, dominance=dom, device="cpu")
    root = tt.root_subproblem(pb)
    states, values, depths, lb, widths, psets = c._roots([root] * K, [W] * K, NEG_INF)
    cache_tab = dom_tab = None
    if tables:
        cache = tt.SimpleCache()
        cache.initialize(pb)
        cache_tab = cache.snapshot("cpu")
        if dom is not None:
            store = tt.SimpleDominanceChecker(dom, pb.nb_variables)
            store.prime(pb)
            dom_tab = store.snapshot("cpu")
    order = None if c.order is None else torch.as_tensor(c.order, dtype=torch.long)
    return dict(datas=c.datas, order=order, root_states=states, root_values=values,
                root_depths=depths, best_lb=lb, eff_width=widths,
                root_path_sets=psets if order is None else None, cache_tab=cache_tab,
                dom_tab=dom_tab)


def _key(bundle, dom, W=8, ct=tt.CompilationType.RELAXED, edit=None, **kw):
    inputs = _inputs(bundle, dom, W=W, **kw)
    if edit is not None:
        edit(inputs)
    spec = mdd.DDSpec(bundle, W, ct, tt.CutsetType.LAST_EXACT_LAYER, dom)
    return mdd.graph_key(spec, inputs)


def test_graph_key_names_the_shape_and_not_the_instance():
    """Two instances of equal shapes share a key, with dominance models
    of their own; a different lane count, width, compilation type, table,
    table length, dominance, order, n or model does not."""
    (b1, d1), (b2, _) = model("knapsack", 1), model("knapsack", 2)
    assert b1.problem.capacity != b2.problem.capacity
    key = _key(b1, d1, tables=True)
    assert key == _key(b2, knapsack.KPDominance(), tables=True)
    assert hash(key) == hash(_key(b2, knapsack.KPDominance(), tables=True))

    def shorter(inputs):
        inputs["cache_tab"] = {k: v[:, :7] for k, v in inputs["cache_tab"].items()}

    def dynamic(inputs):
        inputs["order"] = None

    pb = knapsack.generate_uncorrelated(10, 100, 3, 10, seed=1)
    b10 = tt.ModelBundle(pb, knapsack.KPRelax(pb), knapsack.KPRanking())
    others = [_key(b1, d1, K=3, tables=True), _key(b1, d1, W=16, tables=True),
              _key(b1, d1, ct=tt.CompilationType.RESTRICTED, tables=True),
              _key(b1, d1, tables=False), _key(b1, None, tables=True),
              _key(b1, d1, tables=True, edit=shorter), _key(b1, d1, tables=True, edit=dynamic),
              _key(b10, d1, tables=True), _key(*model("misp", 1), tables=True)]
    assert len({key, *others}) == 1 + len(others)


def test_cpu_compiles_keep_no_graph_state():
    """On the CPU every compile runs eagerly on buffers of its own: nothing
    is kept, no layer counts as replayed, and the planes of two compiles
    are distinct tensors."""
    bundle, dom = model("knapsack", 0)
    c = tt.DDCompiler(bundle, 8, dominance=dom, device="cpu")
    root = tt.root_subproblem(bundle.problem)
    before, graphs = trace.counted("graph_layers"), dict(mdd._GRAPHS)
    a = c.compile_batch(tt.CompilationType.RELAXED, [root], NEG_INF, [3])
    b = c.compile_batch(tt.CompilationType.RELAXED, [root], NEG_INF, [3])
    assert trace.counted("graph_layers") == before and dict(mdd._GRAPHS) == graphs
    assert a.dev["value"] is not b.dev["value"]
    assert torch.equal(a.dev["value"], b.dev["value"])


def test_graph_layer_pct_reader(monkeypatch):
    """100 x graph_layers / layers over the window's unprofiled solves; None
    on the CPU, without a solve to read, and on a port whose stats lack
    `graph_layers`."""
    ring = trace.SOLVES.__class__(maxlen=trace.SOLVES.maxlen)
    monkeypatch.setattr(trace, "SOLVES", ring)
    ring.extend([SolverStats(start=10.5, layers=200, graph_layers=198),
                 SolverStats(start=20.5, layers=100, graph_layers=100),
                 SolverStats(start=30.5, layers=100, graph_layers=0)])
    solves = [dict(start=10.0, end=12.0, profiled=False), dict(start=20.0, end=22.0, profiled=False),
              dict(start=30.0, end=32.0, profiled="device")]
    reader = cells.load_file(os.path.join(cells.HERE, "metrics", "graph_layer_pct.py"))
    assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
        "%", "compile layer loop", "solve_p95_s", "program_counter")
    assert reader.read({"platform": "cpu", "solves": solves, "trace": None}) is None
    assert reader.read({"platform": "gpu", "solves": solves, "trace": None}) == \
        pytest.approx(100.0 * 298 / 300)
    ring.clear()
    assert reader.read({"platform": "gpu", "solves": solves, "trace": None}) is None

    class Parent:  # a port's stats before `graph_layers`
        def __init__(self, start):
            self.start, self.layers = start, 100

    ring.extend([Parent(10.5), Parent(20.5)])
    assert reader.read({"platform": "gpu", "solves": solves, "trace": None}) is None


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("the layer graphs need an NVIDIA GPU")


def _tables(bundle, dom, W, device):
    """Cache and dominance snapshots filled from a relaxed CPU compile's
    threshold rows and exact nodes."""
    pb = bundle.problem
    c = tt.DDCompiler(bundle, W, dominance=dom, device="cpu")
    dd = c.compile(tt.CompilationType.RELAXED, tt.root_subproblem(pb), NEG_INF, 2)
    cache = tt.SimpleCache()
    cache.initialize(pb)
    cache.update_batch(*dd.cache_batch())
    dom_tab = None
    if dom is not None:
        store = tt.SimpleDominanceChecker(dom, pb.nb_variables)
        store.prime(pb)
        store.insert_batch(*dd.exact_nodes_batch())
        dom_tab = store.snapshot(device)
    return cache.snapshot(device), dom_tab


def _fused(bundle, dom, W, K, tables, device):
    """A fused restricted + relaxed compile of K root lanes, its filter
    tables (`tables`: a pair of snapshots, or None) from `_tables`."""
    subs = [tt.root_subproblem(bundle.problem)] * K
    widths = [W] if K == 1 else [2, 3, 5, W][:K]
    cache_tab, dom_tab = tables or (None, None)
    c = tt.DDCompiler(bundle, W, dominance=dom, device=device)
    return c.compile_fused(subs, NEG_INF, widths, cache_tab=cache_tab, dom_tab=dom_tab)


def _planes_equal(got, ref, name):
    cpu = lambda t: mdd.tmap(lambda x: x.cpu(), t)
    for k, v in ref.items():
        _equal(cpu(got[k]), cpu(v), f"{name} plane {k}")


def _eager_layers(spec, inputs, start):
    """`mdd._layers` without graphs: fresh buffers, every layer eager."""
    layers = mdd._Layers(spec, inputs)
    layers.begin(start)
    return layers


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_replayed_compiles_equal_the_cpu(name, K, tables, monkeypatch):
    """Two instances of equal shapes compiled back to back on the card
    (the first captures its graphs, the second replays every layer), each
    read after both ran: every plane equals the CPU path's, and every
    layer of both counts as run through kernel K3.  The models
    whose body waits run every layer eagerly.  talentsched's rough bound
    is a float32 sum that the card adds in another order than the CPU
    (chip_smoke.py phase 5), so its planes are held to the card's eager
    layers instead."""
    _card()
    W = 8
    tabs = {(seed, dev): _tables(*model(name, seed), W, dev) if tables else None
            for seed in (1, 2) for dev in ("cuda", "cpu")}
    mdd._GRAPHS.clear()
    k3 = trace.counted("layer_tail.dominance")
    first = _fused(*model(name, 1), W, K, tabs[1, "cuda"], "cuda")
    layers, graphs = trace.counted("layers"), trace.counted("graph_layers")
    second = _fused(*model(name, 2), W, K, tabs[2, "cuda"], "cuda")
    torch.cuda.synchronize()
    ran, replayed = trace.counted("layers") - layers, trace.counted("graph_layers") - graphs
    n = model(name, 1)[0].problem.nb_variables
    assert ran == 2 * n
    assert replayed == (0 if name in WAITING else ran)
    # every layer's tail, eager, captured or replayed, ran through K3
    assert trace.counted("layer_tail.dominance") - k3 == 2 * ran
    for seed, batches in ((1, first), (2, second)):
        if name == "talentsched":
            with monkeypatch.context() as m:
                m.setattr(mdd, "_layers", _eager_layers)
                ref = _fused(*model(name, seed), W, K, tabs[seed, "cuda"], "cuda")
        else:
            ref = _fused(*model(name, seed), W, K, tabs[seed, "cpu"], "cpu")
        for got, want in zip(batches, ref):
            _planes_equal(got.dev, want.dev, f"{name} seed {seed}")
    entries = [e for e in mdd._GRAPHS.values()]
    if name in WAITING:
        assert entries == [mdd._EAGER] * 2
    else:  # the middle layers' graphs apart from the last layer's
        assert all(set(e.graphs) == {False, True} for e in entries)
        # a replay counts its three graphs, one layer and the one launch
        # of each of K3's parts that the third graph holds
        assert all(g[7] == {"graph_replays": 3, "graph_layers": 1,
                            **{"layer_tail." + p: 1 for p in layer_tail.PARTS}}
                   for e in entries for g in e.graphs.values())


@pytest.mark.cuda
def test_a_live_batch_survives_a_later_compile_of_its_shape():
    """A batch's planes are copies: a third compile of the same shape,
    replayed over the same buffers, leaves the first batch's planes as
    they were."""
    _card()
    bundle, dom = model("knapsack", 3)
    keep = _fused(bundle, dom, 8, 4, _tables(bundle, dom, 8, "cuda"), "cuda")
    before = [{k: mdd.tmap(torch.clone, v) for k, v in b.dev.items()} for b in keep]
    for seed in (4, 5):
        bundle, dom = model("knapsack", seed)
        _fused(bundle, dom, 8, 4, _tables(bundle, dom, 8, "cuda"), "cuda")
    torch.cuda.synchronize()
    for b, saved in zip(keep, before):
        for k, v in saved.items():
            _equal(b.dev[k], v, f"plane {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knapsack", "tsptw", "misp"])
def test_a_replayed_compile_makes_no_host_sync(name):
    """`compile_lanes` of a shape already captured, every input on the
    card, under `set_sync_debug_mode("error")`: no layer, no K1 call and
    no part of the sweep waits on the device."""
    _card()
    W, K = 8, 4
    for seed in (1, 2):  # every layer kind captured
        bundle, dom = model(name, seed)
        _fused(bundle, dom, W, K, _tables(bundle, dom, W, "cuda"), "cuda")
    bundle, dom = model(name, 3)
    c = tt.DDCompiler(bundle, W, dominance=dom, device="cuda")
    subs = [tt.root_subproblem(bundle.problem)] * K
    roots = c._roots(subs, [2, 3, 5, W], NEG_INF)
    cache_tab, dom_tab = _tables(bundle, dom, W, "cuda")
    order = None if c.order is None else torch.as_tensor(c.order, device="cuda")
    spec = c._specs[tt.CompilationType.RELAXED]
    states, values, depths, lb, widths, psets = roots
    torch.cuda.synchronize()
    graphs = trace.counted("graph_layers")
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = mdd.compile_lanes(spec, c.datas, order, states, values, depths, lb, widths,
                                psets, cache_tab=cache_tab, dom_tab=dom_tab)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert trace.counted("graph_layers") - graphs == bundle.problem.nb_variables
    cache_tab, dom_tab = _tables(bundle, dom, W, "cpu")
    ref = tt.DDCompiler(bundle, W, dominance=dom, device="cpu").compile_batch(
        tt.CompilationType.RELAXED, subs, NEG_INF, [2, 3, 5, W], cache_tab=cache_tab,
        dom_tab=dom_tab)
    _planes_equal(out, ref.dev, name)
