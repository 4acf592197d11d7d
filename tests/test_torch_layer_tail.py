"""Kernel K3, the compile layer body's tail (ddo_tpu_torch/engine/layer_tail.py,
csrc/layer_tail.cu), against its plain version.

On the CPU: the wrappers refuse what K3 does not take (dtype, shape,
missing inputs, non-contiguous tensors, tensors off the card) with a clear
error; a CPU compile runs the three plain parts once a layer, counts no
K3 layer and gives every plane of ddo_tpu (knapsack and TSPTW, 1 and 4
lanes); the benchmark's `k3_layer_pct` reader.  On an NVIDIA GPU (marked
`cuda`, skipped without one): every layer of real compiles runs K3's
three parts and their plain versions on copies of the same inputs, and
every output, plane, edge and carried row must agree bit for bit: all
twelve models, restricted and relaxed, with and without filter tables, the
last layer, 1, 4 and 128 lanes, W of 8, 16, 100 and 256, D of 2, 21, 61
and 380, long arcs and a dynamic order (MISP), a recycled merged node,
lanes with no valid row, and an exact layer wider than W.  This file
imports neither jax nor ddo_tpu at module level (the CPU parity test
imports them inside); on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_layer_tail.py
"""

import os

import pytest

torch = pytest.importorskip("torch")

import ddo_tpu_torch as tt
from ddbench import cell as cells
from ddo_tpu_torch.engine import layer_tail as lt, mdd
from ddo_tpu_torch.models import knapsack, misp, sop, tsptw
from ddo_tpu_torch.search.solver import SolverStats
from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import NEG_INF

from test_torch_graph_layer import SPECS, _eager_layers, _fused, _tables, model


def _tree(fn, x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_tree(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return fn(x) if torch.is_tensor(x) else x


def _same(ref, got, what):
    """Every tensor of two trees equal in dtype, shape and value."""
    if ref is None or got is None:
        assert ref is None and got is None, what
    elif isinstance(ref, dict):
        assert ref.keys() == got.keys(), what
        for k in ref:
            _same(ref[k], got[k], f"{what}.{k}")
    elif isinstance(ref, tuple):
        for k, a, b in zip(getattr(ref, "_fields", range(len(ref))), ref, got):
            _same(a, b, f"{what}.{k}")
    else:
        assert ref.dtype == got.dtype and ref.shape == got.shape, what
        if not torch.equal(ref, got):
            at = (ref != got).nonzero()[:4].tolist()
            raise AssertionError(f"{what} differs at {at}")


class _Stop(Exception):
    pass


class Tail:
    """Every layer run eagerly (a comparison cannot be captured into a
    graph; the replays are held to the CPU's planes in
    test_torch_graph_layer.py), with the three parts replaced, in `lt`, by
    one that runs K3's part (`*_cuda`) and its plain version, each on its
    own copy of the buffers it updates, and asserts that both give the
    same outputs and buffers; then K3's results go on.  Counts the layers
    checked, the lanes with a recycled merged node and those with no valid
    row; after `stop_after` layers it ends the compile (`_Stop`)."""

    def __init__(self, monkeypatch, stop_after=None):
        self.kernels = {p: getattr(lt, p + "_cuda") for p in lt.PARTS}
        self.layers = self.recycled = self.empty_lanes = 0
        self.stop_after = stop_after
        for p in lt.PARTS:
            monkeypatch.setattr(lt, p, getattr(self, p))
        monkeypatch.setattr(mdd, "_layers", _eager_layers)

    def remap(self, t):
        got = self.kernels["remap"](t)
        _same(lt.remap_plain(t), got, "remap")
        self.empty_lanes += int((~t["surv"].any(dim=1)).sum())
        return got

    def edges(self, i, t, a, merged_key, rcost, layer, P, E, lel, overflow):
        copies = _tree(torch.clone, (i, P, E, lel, overflow))
        ref = lt.edges_plain(copies[0], t, a, merged_key, rcost, layer, *copies[1:])
        got = self.kernels["edges"](i, t, a, merged_key, rcost, layer, P, E, lel, overflow)
        _same(ref, got, "edges")
        _same(copies, (i, P, E, lel, overflow), "edges' buffers")
        # a relaxed lane whose merged slot takes no fresh state: recycled
        merged = t["need_relax"] & ~got.fresh.any(dim=1)
        self.recycled += int(merged.sum())
        return got

    def dominance(self, i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur):
        copies = _tree(torch.clone, (i, cur))
        lt.dominance_plain(copies[0], nxt, w_dkey, w_dcoord, use_value, c_ebp, copies[1])
        self.kernels["dominance"](i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur)
        _same(copies, (i, cur), "dominance")
        self.layers += 1
        if self.stop_after is not None and self.layers >= self.stop_after:
            raise _Stop()


def _recorded(name="knapsack", K=2, W=8, tables=True, layer=3):
    """A CPU compile's arguments of each of the three parts at its relaxed
    pass's layer `layer`."""
    bundle, dom = model(name, 1)
    tabs = _tables(bundle, dom, W, "cpu") if tables else None
    calls = {p: [] for p in lt.PARTS}
    with pytest.MonkeyPatch.context() as m:
        for p in lt.PARTS:
            plain = getattr(lt, p + "_plain")
            m.setattr(lt, p, lambda *a, p=p, plain=plain: (
                calls[p].append(_tree(torch.clone, a)), plain(*a))[1])
        _fused(bundle, dom, W, K, tabs, "cpu")
    n = bundle.problem.nb_variables
    return {p: c[n + layer] for p, c in calls.items()}


# ---------------------------------------------------------------- the CPU
def test_wrappers_refuse_what_k3_does_not_take():
    """dtype, shape, a missing input, a non-contiguous tensor and a tensor
    off the card each raise a ValueError that names the input; the CPU's
    dispatch takes the plain version."""
    calls = _recorded()
    (t,) = calls["remap"]
    with pytest.raises(ValueError, match=r"surv must be torch.bool"):
        lt.remap_cuda(dict(t, surv=t["surv"].to(torch.int32)))
    with pytest.raises(ValueError, match=r"perm must be torch.int32 \[2, 16\]"):
        lt.remap_cuda(dict(t, perm=t["perm"][:, :8]))
    with pytest.raises(ValueError, match="perm must be contiguous"):
        lt.remap_cuda(dict(t, perm=t["perm"].t().contiguous().t()))
    with pytest.raises(ValueError, match="head is missing"):
        lt.remap_cuda(dict(t, head=None))
    with pytest.raises(ValueError, match="neg_order is on cpu, not on a CUDA device"):
        lt.remap_cuda(t)
    assert isinstance(lt.remap(t), lt.Remap)  # the plain version

    i, t, a, merged_key, rcost, layer, P, E, lel, overflow = calls["edges"]
    args = lambda **kw: dict(dict(i=i, t=t, a=a, merged_key=merged_key, rcost=rcost,
                                  layer=layer, P=P, E=E, lel=lel, overflow=overflow), **kw)
    with pytest.raises(ValueError, match="i must be torch.int64"):
        lt.edges_cuda(**args(i=i.to(torch.int32)))
    with pytest.raises(ValueError, match=r"E.child must be torch.int32"):
        lt.edges_cuda(**args(E=dict(E, child=E["child"][:, :1])))
    with pytest.raises(ValueError, match="layer.wlth is missing"):
        lt.edges_cuda(**args(layer=dict(layer, wlth=None)))
    with pytest.raises(ValueError, match="P.hic must be contiguous"):
        lt.edges_cuda(**args(P=dict(P, hic=P["hic"].transpose(0, 1).contiguous()
                                    .transpose(0, 1))))
    with pytest.raises(ValueError, match="is on cpu"):
        lt.edges_cuda(**args())
    with pytest.raises(ValueError, match=r"C=16 candidates are not a multiple of W=3"):
        lt.edges_cuda(**args(layer={k: v[:, :3] for k, v in layer.items()}))

    i, nxt, w_dkey, w_dcoord, _, c_ebp, cur = calls["dominance"]
    with pytest.raises(ValueError, match="w_dkey and w_dcoord come together"):
        lt.dominance_cuda(i, nxt, w_dkey, None, True, c_ebp, cur)
    with pytest.raises(ValueError, match="cur.ebp must be torch.bool"):
        lt.dominance_cuda(i, nxt, w_dkey, w_dcoord, True, c_ebp,
                          dict(cur, ebp=cur["ebp"].to(torch.int32)))
    with pytest.raises(ValueError, match="is on cpu"):
        lt.dominance_cuda(i, nxt, w_dkey, w_dcoord, True, c_ebp, cur)


def test_edge_codes_refuse_27_bits_of_candidates():
    big = torch.zeros((1, 1 << 27), dtype=torch.bool)
    with pytest.raises(ValueError, match="exceed the 27 bits"):
        lt.remap_cuda(dict(surv=big))


@pytest.mark.parametrize("name", ["knapsack", "misp", "tsptw"])
def test_cpu_compiles_run_the_plain_parts_and_count_no_k3_layer(name):
    """Every layer of a CPU solve runs the three plain parts once, in
    order; no K3 layer is counted, in the process or in the solve's
    stats, and no kernel launch."""
    bundle, dom = model(name, 2)
    seen = []
    with pytest.MonkeyPatch.context() as m:
        for p in lt.PARTS:
            plain = getattr(lt, p + "_plain")
            m.setattr(lt, p + "_plain", lambda *a, p=p, plain=plain: (seen.append(p),
                                                                       plain(*a))[1])
        before, launches = trace.counted("layer_tail.dominance"), trace.counted("layer_tail")
        solver = tt.SequentialSolver(bundle, width_heu=tt.FixedWidth(4), batch=4,
                                     device="cpu", dominance=dom and tt.SimpleDominanceChecker(
                                         dom, bundle.problem.nb_variables))
        solver.maximize()
    assert solver.stats.layers > 0 and solver.stats.k3_layers == 0
    assert trace.counted("layer_tail.dominance") == before
    assert trace.counted("layer_tail") == launches
    assert seen == list(lt.PARTS) * solver.stats.layers


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", ["knapsack", "tsptw"])
def test_plain_tail_gives_the_planes_of_ddo_tpu(name, K):
    """The port's compile on the CPU, through the three cut plain parts,
    against ddo_tpu's, restricted and relaxed, with filter tables
    (knapsack) and with within-layer dominance (TSPTW): every plane of
    every lane, from its root depth down."""
    pytest.importorskip("jax")
    ddo_tpu = pytest.importorskip("ddo_tpu")
    import test_torch_engine as te
    import test_torch_tsptw as tts_

    calls = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(lt, "edges_plain", lambda *a, f=lt.edges_plain: (calls.append(1), f(*a))[1])
        if name == "knapsack":
            jb, tb, rng = te._kp(3, n=10)
            cache_tab, dom_tab = te._tables(jb, rng)
            subs = [(te.j_root(jb.problem), te.t_root(tb.problem))]
            subs += [te._deep(jb.problem, d, 10 * d, jb.problem.capacity // (d + 1))
                     for d in (2, 4, 6)]
            subs = subs[-K:]
            tc = te.TCompiler(tb, 8, te.CS_T.FRONTIER, dominance=knapsack.KPDominance())
            jc = te.JCompiler(jb, 8, te.CS_J.FRONTIER, dominance=__import__(
                "ddo_tpu.models.knapsack", fromlist=["KPDominance"]).KPDominance())
            for comp in ("RESTRICTED", "RELAXED"):
                jbatch = jc.compile_batch(te.CT_J[comp], [s[0] for s in subs], NEG_INF,
                                          [3] * K, cache_tab=cache_tab, dom_tab=dom_tab)
                tbatch = tc.compile_batch(
                    te.CT_T[comp], [s[1] for s in subs], NEG_INF, [3] * K,
                    cache_tab=te.tables_to_device(cache_tab, "cpu"),
                    dom_tab=te.tables_to_device(dom_tab, "cpu"))
                tts_.layer_planes_equal(jbatch._planes.get, tbatch._planes.get,
                                        [s[1].depth for s in subs], ("dkey", "dcoord"))
        else:
            from ddo_tpu.models import tsptw as jts
            jb, tb = tts_.generated_pair()
            tts_.check_compiles(jb, tb, tts_.BITSETS, 8, [2, 3, 8, 4], jts.TsptwDominance(),
                                tsptw.TsptwDominance(),
                                batches=([3],) if K == 1 else ([0, 1, 2, 3],))
    assert calls


def test_k3_layer_pct_reader(monkeypatch):
    """100 x k3_layers / layers over the window's unprofiled solves; None
    on the CPU, without a solve to read, and on a port whose stats lack
    `k3_layers`."""
    ring = trace.SOLVES.__class__(maxlen=trace.SOLVES.maxlen)
    monkeypatch.setattr(trace, "SOLVES", ring)
    ring.extend([SolverStats(start=10.5, layers=200, k3_layers=198),
                 SolverStats(start=20.5, layers=100, k3_layers=100),
                 SolverStats(start=30.5, layers=100, k3_layers=0)])
    solves = [dict(start=10.0, end=12.0, profiled=False), dict(start=20.0, end=22.0, profiled=False),
              dict(start=30.0, end=32.0, profiled="device")]
    reader = cells.load_file(os.path.join(cells.HERE, "metrics", "k3_layer_pct.py"))
    assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
        "%", "compile layer loop", "solve_p95_s", "program_counter")
    assert reader.read({"platform": "cpu", "solves": solves, "trace": None}) is None
    assert reader.read({"platform": "gpu", "solves": solves, "trace": None}) == \
        pytest.approx(100.0 * 298 / 300)
    ring.clear()
    assert reader.read({"platform": "gpu", "solves": solves, "trace": None}) is None

    class Parent:  # a port's stats before `k3_layers`
        def __init__(self, start):
            self.start, self.layers, self.graph_layers = start, 100, 100

    ring.extend([Parent(10.5), Parent(20.5)])
    assert reader.read({"platform": "gpu", "solves": solves, "trace": None}) is None


# ---------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("kernel K3 needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_k3_equals_its_plain_version_in_every_layer(name, K, tables, monkeypatch):
    """A fused restricted + relaxed compile on the card, every layer's
    three parts against their plain versions, then the planes against the
    CPU's."""
    _card()
    W = 8
    bundle, dom = model(name, 1)
    tabs = _tables(bundle, dom, W, "cuda") if tables else None
    tail = Tail(monkeypatch)
    launches = trace.counted("layer_tail")
    got = _fused(bundle, dom, W, K, tabs, "cuda")
    torch.cuda.synchronize()
    assert tail.layers == 2 * bundle.problem.nb_variables
    assert trace.counted("layer_tail") - launches == 3 * tail.layers
    monkeypatch.undo()
    if name != "talentsched":  # its float32 rough bound adds in another order
        ref = _fused(bundle, dom, W, K, _tables(bundle, dom, W, "cpu") if tables else None,
                     "cpu")
        for g, r in zip(got, ref):
            for k, v in r.dev.items():
                _same(_tree(lambda x: x.cpu(), v), _tree(lambda x: x.cpu(), g.dev[k]), k)


#: (model, instance, K, W, layers checked): D of 2, 21, 61 and 380, lanes
#: up to 128, W not a multiple of 16
SHAPES = [
    ("knapsack", lambda: knapsack.generate_uncorrelated(100, 1000, 50, 100, seed=3), 128, 256,
     None),
    ("knapsack", lambda: knapsack.generate_uncorrelated(100, 1000, 50, 100, seed=4), 1, 256,
     None),
    ("tsptw", lambda: tsptw.generate_random(21, 5, window=40.0), 1, 256, None),
    ("tsptw", lambda: tsptw.generate_random(21, 6, window=40.0), 4, 16, None),
    ("tsptw", lambda: tsptw.generate_random(61, 7, window=100.0), 128, 256, 8),
    ("misp", lambda: misp.generate_gnp(60, 0.2, seed=8)[0], 128, 100, None),
    ("sop", lambda: sop.generate_random(380, seed=9), 1, 256, 6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_k3_equals_its_plain_version_at_the_paths_shapes(case, monkeypatch):
    """The main paths' shapes: the first layers (`layers checked`) or all
    of a fused compile from the root at W, K lanes of widths up to W."""
    _card()
    name, make, K, W, stop = SHAPES[case]
    pb = make()
    _, relax, ranking, dom = SPECS[name]
    bundle = tt.ModelBundle(pb, relax(pb), ranking(pb))
    dom = dom() if dom else None
    assert pb.domain_size in (2, 21, 61, 380) or name == "misp"
    tail = Tail(monkeypatch, stop_after=stop)
    c = tt.DDCompiler(bundle, W, dominance=dom, device="cuda")
    subs = [tt.root_subproblem(pb)] * K
    widths = [max(1, W - 7 * k) for k in range(K)]
    try:
        c.compile_fused(subs, NEG_INF, widths)
    except _Stop:
        pass
    torch.cuda.synchronize()
    assert tail.layers == (stop or 2 * pb.nb_variables)


@pytest.mark.cuda
def test_k3_at_edge_cases(monkeypatch):
    """A recycled merged node, lanes with no valid row (a lower bound no
    completion reaches) and an exact compile wider than W (overflow): K3
    against its plain version in every layer."""
    _card()
    tail = Tail(monkeypatch)
    for name in ("knapsack", "misp", "tsptw", "golomb", "lcs"):
        for seed in (1, 2, 3):
            bundle, dom = model(name, seed)
            _fused(bundle, dom, 8, 4, None, "cuda")
    assert tail.recycled > 0
    bundle, dom = model("knapsack", 1)
    c = tt.DDCompiler(bundle, 8, dominance=dom, device="cuda")
    root = tt.root_subproblem(bundle.problem)
    before = tail.empty_lanes
    c.compile_batch(tt.CompilationType.RELAXED, [root] * 3, 10**6, [8, 3, 2])
    assert tail.empty_lanes > before
    dd = c.compile(tt.CompilationType.EXACT, root, NEG_INF, 2)
    with pytest.raises(mdd.BufferOverflow):
        dd.best_value()
    torch.cuda.synchronize()
