"""Engine parity: every plane of the port's compiled diagrams
(ddo_tpu_torch/engine/mdd.py) equal to ddo_tpu's `out` dict
(ddo_tpu/engine/mdd.py:1044-1060), bit for bit, on the test_engine.py
fixtures, random knapsack instances with and without cache/dominance
filter tables, a deep-rooted subproblem and a fused K=3 superstep."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.core.types import SubProblem as JSub, root_subproblem as j_root
from ddo_tpu.engine.mdd import DDCompiler as JCompiler
from ddo_tpu.models import knapsack as jk
from ddo_tpu_torch.core import problem as tp
from ddo_tpu_torch.core.types import SubProblem as TSub, root_subproblem as t_root
from ddo_tpu_torch.engine.mdd import BufferOverflow, CutoffInterrupt, DDCompiler
from ddo_tpu_torch.models import knapsack as tk
from ddo_tpu_torch.search.cache import tables_to_device
from ddo_tpu_torch.utils.num import NEG_INF

import test_engine as te

I32 = torch.int32
CT_J, CT_T = ddo_tpu.CompilationType, tt.CompilationType
CS_J, CS_T = ddo_tpu.CutsetType, tt.CutsetType

PLANES = ["value", "mask", "exact", "relaxed", "keys", "rank0", "rub", "bp", "bd",
          "bs", "var_of", "value_bot", "marked", "theta", "has_theta", "above",
          "cutflag", "wl_pruned", "wl_unexplored", "lel", "is_exact_dd", "has_ebp",
          "feasible", "best_slot", "best_value", "bx_feasible", "bx_slot",
          "bx_value", "expanded", "overflow", "root_depth"]


def assert_planes_equal(j, t, extra=()):
    """`j`, `t`: plane lookups (a CompiledDD's `o`, or a batch's
    `_planes.get` for every lane at once)."""
    j = j if callable(j) else j.__getitem__
    t = t if callable(t) else t.__getitem__
    for k in PLANES + list(extra):
        np.testing.assert_array_equal(np.asarray(j(k)), np.asarray(t(k)), err_msg=k)
    js, ts = j("state"), t("state")
    if isinstance(js, dict):
        for leaf in js:
            np.testing.assert_array_equal(np.asarray(js[leaf]), ts[leaf], err_msg=leaf)
    else:
        np.testing.assert_array_equal(np.asarray(js), ts, err_msg="state")


def TCompiler(*args, **kw):
    """The port's compiler on the CPU (its plain PyTorch route)."""
    return DDCompiler(*args, device="cpu", **kw)


# ---------------------------------------- the test_engine.py fixtures, ported
class DummyProblem(tp.Problem):
    name = "dummy"
    nb_variables = 3
    domain_size = 3

    def initial_state(self):
        return dict(value=np.asarray(0, np.int32), depth=np.asarray(0, np.int32))

    def step(self, data, states, var, depth):
        B = var.shape[0]
        d = torch.arange(3, dtype=I32).expand(B, 3)
        nxt = dict(value=states["value"][:, None] + d,
                   depth=(states["depth"] + 1)[:, None].expand(B, 3))
        return nxt, d, d, torch.ones((B, 3), dtype=torch.bool)


class DummyInfeasibleProblem(DummyProblem):
    def step(self, data, states, var, depth):
        nxt, cost, dv, valid = super().step(data, states, var, depth)
        return nxt, cost, dv, torch.zeros_like(valid)


class DummyRelax(tp.Relaxation):
    def merge(self, data, states, mask):
        depth = torch.where(mask, states["depth"], 0).amax(dim=1)
        return dict(value=torch.full_like(depth, 100), depth=depth)

    def relax_cost(self, data, src, dst, merged, dval, cost, var):
        return torch.full_like(cost, 20)

    def rub(self, data, states, depth):
        return (3 - states["depth"]) * 10


class DummyRanking(tp.StateRanking):
    def score(self, data, states):
        return -states["value"][:, None]


class DummyDom(tp.Dominance):
    use_value = True

    def key_cols(self, states):
        return torch.zeros((states["value"].shape[0], 0), dtype=I32)

    def coord_cols(self, states):
        return states["value"][:, None]


class LocBoundsExamplePb(tp.Problem):
    name = "locbex"
    nb_variables = 4
    domain_size = 3

    def data(self, device):
        return tuple(torch.as_tensor(a, device=device)
                     for a in (te._NEXT, te._COST, te._VALID))

    def initial_state(self):
        return np.asarray(te.R, np.int32)

    def step(self, data, states, var, depth):
        nxt_t, cost_t, valid_t = data
        s = states.long()
        return nxt_t[s], cost_t[s], cost_t[s], valid_t[s]


class LocBoundsExampleRelax(tp.Relaxation):
    def data(self, device):
        return torch.as_tensor(te._RUB, device=device)

    def merge(self, data, states, mask):
        return torch.full((states.shape[0],), te.M, dtype=I32)

    def rub(self, data, states, depth):
        return data[states.long()]


class CmpState(tp.StateRanking):
    def score(self, data, states):
        return states[:, None].to(I32)


def _bundles(name):
    if name == "dummy":
        return (ddo_tpu.ModelBundle(te.DummyProblem(), te.DummyRelax(), te.DummyRanking()),
                tp.ModelBundle(DummyProblem(), DummyRelax(), DummyRanking()))
    if name == "infeasible":
        return (ddo_tpu.ModelBundle(te.DummyInfeasibleProblem(), te.DummyRelax(),
                                    te.DummyRanking()),
                tp.ModelBundle(DummyInfeasibleProblem(), DummyRelax(), DummyRanking()))
    return (ddo_tpu.ModelBundle(te.LocBoundsExamplePb(), te.LocBoundsExampleRelax(),
                                te.CmpState()),
            tp.ModelBundle(LocBoundsExamplePb(), LocBoundsExampleRelax(), CmpState()))


@pytest.mark.parametrize("cutset", ["LAST_EXACT_LAYER", "FRONTIER"])
@pytest.mark.parametrize("comp", ["EXACT", "RELAXED", "RESTRICTED"])
@pytest.mark.parametrize("name,W", [("dummy", 16), ("infeasible", 16), ("locb", 8)])
def test_fixture_planes_match(name, W, comp, cutset):
    jb, tb = _bundles(name)
    jc = JCompiler(jb, W, CS_J[cutset])
    tc = TCompiler(tb, W, CS_T[cutset])
    for width in (1, 3, 10):
        for best_lb in (NEG_INF, 0, 15, 1000):
            jd = jc.compile(CT_J[comp], j_root(jb.problem), best_lb, width)
            td = tc.compile(CT_T[comp], t_root(tb.problem), best_lb, width)
            assert_planes_equal(jd.o, td.o)


def test_fixture_within_layer_dominance_matches():
    """test_engine.py's within-layer dominance case, and the snapshot
    dominance and cache-filter cases, plane for plane."""
    jb, tb = _bundles("dummy")
    j_ck = ddo_tpu.SimpleCache()
    j_ck.initialize(jb.problem)
    j_ck.update_batch(np.asarray([1]), np.asarray([[1, 2]], np.int32),
                      np.asarray([5]), np.asarray([1]))
    j_dom = ddo_tpu.SimpleDominanceChecker(te.DummyDom(), 3)
    j_dom.insert_batch(np.asarray([1, 2]), np.zeros((2, 0), np.int32),
                       np.asarray([[1], [5]], np.int32), np.asarray([1, 5]))
    for cache_tab, dom_tab in [(None, None), (j_ck.snapshot(), None),
                               (None, j_dom.snapshot())]:
        for comp in ("EXACT", "RELAXED"):
            jd = JCompiler(jb, 16, CS_J.FRONTIER, dominance=te.DummyDom()).compile(
                CT_J[comp], j_root(jb.problem), NEG_INF, 2,
                cache_tab=cache_tab, dom_tab=dom_tab)
            td = TCompiler(tb, 16, CS_T.FRONTIER, dominance=DummyDom()).compile(
                CT_T[comp], t_root(tb.problem), NEG_INF, 2,
                cache_tab=tables_to_device(cache_tab, "cpu"),
                dom_tab=tables_to_device(dom_tab, "cpu"))
            assert_planes_equal(jd.o, td.o, extra=("dkey", "dcoord"))


# --------------------------------------------------------- random knapsack
def _kp(seed, n=10):
    rng = np.random.default_rng(seed)
    profit = rng.integers(1, 60, n)
    weight = rng.integers(1, 25, n)
    jp = jk.Knapsack(int(weight.sum() // 2), profit, weight)
    tpb = tk.Knapsack.from_numpy(jp.capacity, jp.profit, jp.weight)
    return (ddo_tpu.ModelBundle(jp, jk.KPRelax(jp), jk.KPRanking()),
            tp.ModelBundle(tpb, tk.KPRelax(tpb), tk.KPRanking()), rng)


def _tables(jb, rng):
    """Cache and dominance snapshots filled from a first compile's
    threshold rows and exact nodes, plus random rows."""
    pb = jb.problem
    dd = JCompiler(jb, 8, CS_J.FRONTIER, dominance=jk.KPDominance()).compile(
        CT_J.RELAXED, j_root(pb), NEG_INF, 2)
    cache = ddo_tpu.SimpleCache()
    cache.initialize(pb)
    cache.update_batch(*dd.cache_batch())
    dom = ddo_tpu.SimpleDominanceChecker(jk.KPDominance(), pb.nb_variables)
    dom.insert_batch(*dd.exact_nodes_batch())
    m = 20
    d = rng.integers(1, pb.nb_variables, m)
    caps = rng.integers(0, pb.capacity + 1, (m, 1)).astype(np.int32)
    vals = rng.integers(0, 200, m)
    cache.update_batch(d, caps, vals, rng.integers(0, 2, m))
    dom.insert_batch(d, np.zeros((m, 0), np.int32), caps, vals)
    return cache.snapshot(), dom.snapshot()


@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("cutset", ["LAST_EXACT_LAYER", "FRONTIER"])
@pytest.mark.parametrize("comp", ["RESTRICTED", "RELAXED"])
def test_knapsack_planes_match(comp, cutset, tables):
    for seed in range(2):
        jb, tb, rng = _kp(seed)
        cache_tab, dom_tab = _tables(jb, rng) if tables else (None, None)
        jdom, tdom = (jk.KPDominance(), tk.KPDominance()) if tables else (None, None)
        jc = JCompiler(jb, 8, CS_J[cutset], dominance=jdom)
        tc = TCompiler(tb, 8, CS_T[cutset], dominance=tdom)
        for width, best_lb in [(1, NEG_INF), (3, NEG_INF), (3, 150), (8, NEG_INF)]:
            jd = jc.compile(CT_J[comp], j_root(jb.problem), best_lb, width,
                            cache_tab=cache_tab, dom_tab=dom_tab)
            td = tc.compile(CT_T[comp], t_root(tb.problem), best_lb, width,
                            cache_tab=tables_to_device(cache_tab, "cpu"),
                            dom_tab=tables_to_device(dom_tab, "cpu"))
            assert_planes_equal(jd.o, td.o, extra=("dkey", "dcoord") if tables else ())


def _deep(pb_j, depth, value, cap):
    vals = np.zeros(pb_j.nb_variables, np.int32)
    pset = np.zeros(pb_j.nb_variables, bool)
    pset[:depth] = True
    state = {"capacity": np.asarray(cap, np.int32)}
    return (JSub(state=state, value=value, path_vals=vals, path_set=pset, ub=10**9,
                 depth=depth),
            TSub(state=state, value=value, path_vals=vals, path_set=pset, ub=10**9,
                 depth=depth))


@pytest.mark.parametrize("comp", ["RESTRICTED", "RELAXED"])
def test_deep_rooted_subproblem_matches(comp):
    """A subproblem rooted at depth 7 of 12 (test_engine_paths.py:120-163):
    the port starts its layer loop at the root depth; ddo_tpu scans from
    layer 0 over empty layers.  The planes agree."""
    jb, tb, _ = _kp(11, n=12)
    js, ts = _deep(jb.problem, 7, 5, jb.problem.capacity // 3)
    jd = JCompiler(jb, 8, CS_J.FRONTIER).compile(CT_J[comp], js, NEG_INF, 4)
    td = TCompiler(tb, 8, CS_T.FRONTIER).compile(CT_T[comp], ts, NEG_INF, 4)
    assert_planes_equal(jd.o, td.o)


def test_compile_fused_three_lanes_matches():
    """compile_fused at K=3 with lanes at different root depths: both
    batches' planes and the cross-lane reductions."""
    jb, tb, _ = _kp(4, n=12)
    cap = jb.problem.capacity
    subs = [(j_root(jb.problem), t_root(tb.problem)),
            _deep(jb.problem, 3, 40, cap // 2), _deep(jb.problem, 5, 70, cap // 4)]
    jr, jx = JCompiler(jb, 8, CS_J.LAST_EXACT_LAYER).compile_fused(
        [s[0] for s in subs], NEG_INF, [2, 3, 2])
    tr, tx = TCompiler(tb, 8, CS_T.LAST_EXACT_LAYER).compile_fused(
        [s[1] for s in subs], NEG_INF, [2, 3, 2])
    for jbatch, tbatch in ((jr, tr), (jx, tx)):
        assert_planes_equal(jbatch._planes.get, tbatch._planes.get)
        assert jbatch.global_best == tbatch.global_best
        assert jbatch.total_expanded == tbatch.total_expanded


# ------------------------------------------------------ port-only behaviour
def test_chunked_compile_matches_unchunked_and_interrupts():
    _, tb, _ = _kp(2, n=9)
    tc = TCompiler(tb, 8, CS_T.FRONTIER)
    root = t_root(tb.problem)

    class Never(tt.NoCutoff):
        pass

    class Fires:
        def must_stop(self):
            return True

    for comp in (CT_T.RELAXED, CT_T.RESTRICTED):
        ref = tc.compile_batch(comp, [root, root], NEG_INF, [2, 3])
        got = tc.compile_batch(comp, [root, root], NEG_INF, [2, 3], cutoff=Never(),
                               chunk_layers=2)
        assert_planes_equal(ref._planes.get, got._planes.get)
    with pytest.raises(CutoffInterrupt):
        tc.compile_batch(CT_T.RELAXED, [root], NEG_INF, [2], cutoff=Fires(),
                         chunk_layers=1)


def test_exact_compile_overflowing_buffer_raises():
    _, tb = _bundles("dummy")
    tc = TCompiler(tb, 2, CS_T.LAST_EXACT_LAYER)
    dd = tc.compile(CT_T.EXACT, t_root(tb.problem), NEG_INF, 2)
    with pytest.raises(BufferOverflow):
        dd.best_value()
    dd = tc.compile(CT_T.RESTRICTED, t_root(tb.problem), NEG_INF, 2)
    assert dd.best_value() is not None


def test_host_queries_match():
    """drain_cutset / cache_updates / best_solution on the LEL fixture."""
    jb, tb = _bundles("locb")
    for cutset in ("LAST_EXACT_LAYER", "FRONTIER"):
        jd = JCompiler(jb, 8, CS_J[cutset]).compile(CT_J.RELAXED, j_root(jb.problem), 0, 3)
        td = TCompiler(tb, 8, CS_T[cutset]).compile(CT_T.RELAXED, t_root(tb.problem), 0, 3)
        jc = [(int(np.asarray(c.state)), c.ub, c.depth, c.key) for c in jd.drain_cutset()]
        tc = [(int(np.asarray(c.state)), c.ub, c.depth, c.key) for c in td.drain_cutset()]
        assert jc == tc
        assert list(jd.cache_updates()) == list(td.cache_updates())
        jv, jpset = jd.best_solution()
        tv, tpset = td.best_solution()
        np.testing.assert_array_equal(jv, tv)
        np.testing.assert_array_equal(jpset, tpset)
