"""TSPTW parity (ddo_tpu_torch/models/tsptw.py) against ddo_tpu, and the
helpers that the other new models' parity files share:

  * every hook (`step`, `pack`/`unpack`, `merge`, `rub`, `score`, the
    dominance columns, `is_impacted_by` where a model has long arcs)
    against ddo_tpu's under `jax.vmap`, on random reachable states;
  * every plane of a restricted and a relaxed compile, at batch 1 (a deep
    root) and batch 4 (lanes rooted at different depths), compared from
    each lane's root depth down; TSPTW's with its dominance, whose
    coordinate columns are empty (value alone), in the layer and from a
    dominance snapshot;
  * the solver's proved optimum against brute force on the seeds of
    tests/test_tsptw.py, with ddo_tpu's explored and expanded counts at
    batch 1.

One instance is built from numpy arrays and crosses into both packages
(`from_numpy`); bitset words cross as `.view` between uint32 and int32.
Tolerance: exact, every value is an integer or a bool."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.core.types import SubProblem as JSub, root_subproblem as j_root
from ddo_tpu.engine.mdd import DDCompiler as JCompiler
from ddo_tpu.models import tsptw as jts
from ddo_tpu_torch.core import problem as tp
from ddo_tpu_torch.engine.mdd import DDCompiler, _check_sort_operands
from ddo_tpu_torch.models import tsptw as tts
from ddo_tpu_torch.search.cache import tables_to_device
from ddo_tpu_torch.utils.num import NEG_INF

from test_torch_engine import PLANES
from test_tsptw import brute_force as tsptw_brute_force

B = 16  # walkers of a rollout
CT_J, CT_T = ddo_tpu.CompilationType, tt.CompilationType


# ------------------------------------------------------- shared helpers
def to_jax_state(state, bitsets):
    """A port state (numpy or torch leaves, int32 words) as ddo_tpu's."""
    out = {}
    for k, v in state.items():
        a = np.ascontiguousarray(v.numpy() if torch.is_tensor(v) else np.asarray(v))
        out[k] = jnp.asarray(a.view(np.uint32) if k in bitsets else a)
    return out


def assert_state_equal(jstate, tstate, bitsets, msg=""):
    for k in jstate:
        j = np.ascontiguousarray(np.asarray(jstate[k]))
        t = tstate[k].numpy() if torch.is_tensor(tstate[k]) else np.asarray(tstate[k])
        if k in bitsets:
            j = j.view(np.int32)
        np.testing.assert_array_equal(j, t, err_msg=f"{msg} {k}")


def rollout(tb):
    """[(depth, states [B, ...], var [B])]: B random walks of the port's
    own `step` from the root (a walker with no valid slot stays), so every
    state is reachable."""
    pb = tb.problem
    data = pb.data("cpu")
    n = pb.nb_variables
    rng = np.random.default_rng(7)
    st = {k: torch.as_tensor(np.stack([np.asarray(v)] * B))
          for k, v in pb.initial_state().items()}
    order = pb.var_order()
    rows = np.arange(B)
    layers = []
    for depth in range(n):
        var = np.full(B, order[depth])
        layers.append((depth, st, var))
        nstate, _, _, valid = pb.step(data, st, torch.as_tensor(var), depth)
        valid = valid.numpy()
        pick = np.asarray([rng.choice(np.flatnonzero(valid[b])) if valid[b].any() else -1
                           for b in range(B)])
        moved = torch.as_tensor(pick >= 0)
        st = {k: torch.where(moved.reshape((B,) + (1,) * (st[k].dim() - 1)),
                             nstate[k][rows, np.maximum(pick, 0)], st[k]) for k in st}
    return layers


def check_hooks(jb, tb, bitsets, layers, jdom=None, tdom=None):
    """Every hook of the port against ddo_tpu's on the rollout's states."""
    jp, pb = jb.problem, tb.problem
    D = pb.domain_size
    data, rdata = pb.data("cpu"), tb.relaxation.data("cpu")
    rng = np.random.default_rng(3)
    for depth, st, var in layers:
        js = to_jax_state(st, bitsets)
        jvar = jnp.asarray(var, jnp.int32)
        nstate, cost, dval, valid = pb.step(data, st, torch.as_tensor(var), depth)
        jn, jc, jd, jv = jax.vmap(lambda s, v: jax.vmap(
            lambda d: jp.step(jp.data, s, v, d, depth))(jnp.arange(D, dtype=jnp.int32)))(js, jvar)
        assert_state_equal(jn, nstate, bitsets, f"step {depth}")
        assert cost.dtype == dval.dtype == torch.int32 and valid.dtype == torch.bool
        np.testing.assert_array_equal(np.asarray(jc), cost.numpy(), err_msg=f"cost {depth}")
        np.testing.assert_array_equal(np.asarray(jd), dval.numpy(), err_msg=f"dval {depth}")
        np.testing.assert_array_equal(np.broadcast_to(np.asarray(jv), valid.shape),
                                      valid.numpy(), err_msg=f"valid {depth}")
        np.testing.assert_array_equal(np.asarray(jax.vmap(jp.pack)(js)), pb.pack(st).numpy())
        score = tb.ranking.score(tb.ranking.data("cpu"), st)
        ref = jax.vmap(lambda s: jnp.atleast_1d(jb.ranking.score(jb.ranking.data, s)))(js)
        assert score.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ref), score.numpy())
        rub = tb.relaxation.rub(rdata, st, depth)
        ref = jax.vmap(lambda s: jb.relaxation.rub(jb.relaxation.data, s, depth))(js)
        assert rub.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ref), rub.numpy(), err_msg=f"rub {depth}")
        for mask in (rng.random(B) < 0.5, np.zeros(B, bool), np.ones(B, bool)):
            merged = tb.relaxation.merge(rdata, {k: v[None] for k, v in st.items()},
                                         torch.as_tensor(mask)[None])
            jm = jb.relaxation.merge(jb.relaxation.data, js, jnp.asarray(mask))
            assert_state_equal(jm, {k: v[0] for k, v in merged.items()}, bitsets,
                               f"merge {depth}")
        if jdom is not None:
            for hook in ("key_cols", "coord_cols"):
                got = getattr(tdom, hook)(st)
                ref = jax.vmap(getattr(jdom, hook))(js)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(np.asarray(ref).reshape(got.shape), got.numpy(),
                                              err_msg=hook)
        if tt.engine.mdd.has_long_arcs(pb):
            np.testing.assert_array_equal(
                np.asarray(jax.vmap(lambda s, v: jp.is_impacted_by(jp.data, s, v))(js, jvar)),
                pb.is_impacted_by(data, st, torch.as_tensor(var)).numpy())
    # unpack inverts pack on the host
    st = layers[-1][1]
    back = pb.unpack(pb.pack(st)[3].numpy())
    assert_state_equal({k: v[3].numpy() for k, v in st.items()},
                       {k: np.asarray(v) for k, v in back.items()}, ())


def deep_subs(tb, W, count=3):
    """Port subproblems rooted at `count` different depths > 0: cutset
    nodes of relaxed compiles of the root on the CPU, at growing widths
    and with both cutsets, the best-valued node of each depth."""
    root = tt.root_subproblem(tb.problem)
    by_depth = {}
    for cutset in (tt.LAST_EXACT_LAYER, tt.FRONTIER):
        cpu = DDCompiler(tb, W, cutset, device="cpu")
        for width in range(1, W + 1):
            for s in cpu.compile(CT_T.RELAXED, root, NEG_INF, width).drain_cutset():
                if s.depth > 0 and s.value > by_depth.get(s.depth, s).value - 1:
                    by_depth[s.depth] = s
    subs = [by_depth[d] for d in sorted(by_depth)][:count]
    assert len(subs) == count, f"only {len(subs)} cutset depths"
    return subs


def to_jax_sub(sub, bitsets):
    state = {k: (np.asarray(v).view(np.uint32) if k in bitsets else np.asarray(v))
             for k, v in sub.state.items()}
    return JSub(state=state, value=sub.value, path_vals=sub.path_vals.copy(),
                path_set=sub.path_set.copy(), ub=sub.ub, depth=sub.depth, key=sub.key)


def layer_planes_equal(jget, tget, depths, extra=()):
    """Every plane of a batch (`jget`/`tget`: plane name -> [K, ...] numpy),
    lane k compared from its root depth `depths[k]` down on the planes
    indexed by layer (ROADMAP C.4)."""
    for name in PLANES + list(extra) + ["state"]:
        j, t = jget(name), tget(name)
        pairs = list(j.items()) if isinstance(j, dict) else [(name, j)]
        for leaf, jv in pairs:
            jv = np.asarray(jv)
            tv = np.asarray(t[leaf] if isinstance(t, dict) else t)
            if jv.dtype == np.uint32:
                jv = jv.view(np.int32)
            assert jv.shape == tv.shape, (leaf, jv.shape, tv.shape)
            for k, d in enumerate(depths):
                a, b = (jv[k], tv[k]) if jv.ndim == 1 else (jv[k, d:], tv[k, d:])
                np.testing.assert_array_equal(a, b, err_msg=f"{leaf} lane {k}")


def check_compiles(jb, tb, bitsets, W, widths, jdom=None, tdom=None, tables=None,
                   batches=([3], [0, 1, 2, 3])):
    """Restricted and relaxed compiles, batch 1 (the deepest root) and
    batch 4 (the root and three deeper ones), every plane equal."""
    deep = deep_subs(tb, W)
    t_subs = [tt.root_subproblem(tb.problem)] + deep
    j_subs = [j_root(jb.problem)] + [to_jax_sub(s, bitsets) for s in deep]
    jc = JCompiler(jb, W, ddo_tpu.FRONTIER, dominance=jdom)
    tc = DDCompiler(tb, W, tt.FRONTIER, dominance=tdom, device="cpu")
    jtab, ttab = (None, None), (None, None)
    if tables is not None:
        jtab = tables
        ttab = tuple(tables_to_device(t, "cpu") for t in tables)
    extra = ("dkey", "dcoord") if jdom is not None else ()
    for comp in ("RESTRICTED", "RELAXED"):
        for lanes in batches:
            jbatch = jc.compile_batch(CT_J[comp], [j_subs[i] for i in lanes], NEG_INF,
                                      [widths[i] for i in lanes], cache_tab=jtab[0],
                                      dom_tab=jtab[1])
            tbatch = tc.compile_batch(CT_T[comp], [t_subs[i] for i in lanes], NEG_INF,
                                      [widths[i] for i in lanes], cache_tab=ttab[0],
                                      dom_tab=ttab[1])
            layer_planes_equal(jbatch._planes.get, tbatch._planes.get,
                               [t_subs[i].depth for i in lanes], extra)
            assert jbatch.total_expanded == tbatch.total_expanded
    return t_subs


def check_counts(jsolver, tsolver):
    """The same search trajectory at batch 1 (plane route on both sides)."""
    assert jsolver.maximize().is_exact and tsolver.maximize().is_exact
    assert jsolver._compact is False and tsolver._compact is False
    assert tsolver.best_value() == jsolver.best_value()
    assert tsolver.best_upper_bound() == jsolver.best_upper_bound()
    assert (tsolver.explored_count, tsolver.expanded_nodes, tsolver.stats.supersteps) == \
        (jsolver.explored_count, jsolver.expanded_nodes, jsolver.stats.supersteps)
    if jsolver.best_solution() is not None:
        for a, b in zip(jsolver.best_solution(), tsolver.best_solution()):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- the TSPTW instance
BITSETS = {"pos", "must", "maybe"}


def tsptw_arrays(seed):
    """tests/test_tsptw.py:58's random instance for `seed`."""
    rng = np.random.default_rng(500 + seed)
    n = int(rng.integers(4, 8))
    xy = rng.uniform(0, 50, (n, 2))
    dist = np.sqrt(((xy[:, None] - xy[None, :]) ** 2).sum(-1)).astype(np.int64)
    width = int(rng.integers(20, 80))
    twe = rng.integers(0, 100, n)
    twl = twe + rng.integers(width, 250, n)
    twe[0], twl[0] = 0, 10**6
    return dist, twe, twl, int(rng.integers(2, 8))


def tsptw_pair(dist, twe, twl):
    jp = jts.Tsptw(dist, twe, twl)
    pb = tts.Tsptw.from_numpy(jp.dist, jp.twe, jp.twl)
    return (ddo_tpu.ModelBundle(jp, jts.TsptwRelax(jp), jts.TsptwRanking()),
            tp.ModelBundle(pb, tts.TsptwRelax(pb), tts.TsptwRanking()))


def generated_pair(n=8, seed=1):
    pb = tts.generate_random(n, seed, window=60.0)
    return tsptw_pair(pb.dist, pb.twe, pb.twl)


def test_tsptw_hooks_match():
    jb, tb = generated_pair()
    check_hooks(jb, tb, BITSETS, rollout(tb), jts.TsptwDominance(), tts.TsptwDominance())


@pytest.mark.parametrize("comp_type", ["dominance", "snapshot"])
def test_tsptw_planes_match(comp_type):
    """Restricted and relaxed compiles with the zero-coordinate dominance:
    within the layer, and also from a snapshot of a dominance store filled
    with every exact node of a first compile."""
    jb, tb = generated_pair()
    jdom, tdom = jts.TsptwDominance(), tts.TsptwDominance()
    tables, batches = None, ([3], [0, 1, 2, 3])
    if comp_type == "snapshot":
        batches = ([0, 1, 2, 3],)
        first = JCompiler(jb, 8, ddo_tpu.FRONTIER, dominance=jdom).compile(
            CT_J.RELAXED, j_root(jb.problem), NEG_INF, 3)
        store = ddo_tpu.SimpleDominanceChecker(jdom, jb.problem.nb_variables)
        store.insert_batch(*first.exact_nodes_batch())
        tables = (None, store.snapshot())
    check_compiles(jb, tb, BITSETS, 8, [2, 3, 8, 4], jdom, tdom, tables, batches=batches)


def _tsptw_solvers(seed):
    dist, twe, twl, width = tsptw_arrays(seed)
    jb, tb = tsptw_pair(dist, twe, twl)
    n = jb.problem.nb_variables
    kw = dict(batch=1, buffer_width=16)
    js = ddo_tpu.SequentialSolver(
        jb, width_heu=ddo_tpu.FixedWidth(width), cache=ddo_tpu.SimpleCache(),
        cutset_type=ddo_tpu.FRONTIER,
        dominance=ddo_tpu.SimpleDominanceChecker(jts.TsptwDominance(), n), **kw)
    ts = tt.SequentialSolver(
        tb, width_heu=tt.FixedWidth(width), cache=tt.SimpleCache(), cutset_type=tt.FRONTIER,
        dominance=tt.SimpleDominanceChecker(tts.TsptwDominance(), n), device="cpu", **kw)
    return js, ts, (dist, twe, twl)


@pytest.mark.parametrize("seed", range(5))
def test_tsptw_random_vs_bruteforce(seed):
    """tests/test_tsptw.py's instances: the proved optimum is brute
    force's, and the tour replays within every window at its cost."""
    _, ts, (dist, twe, twl) = _tsptw_solvers(seed)
    expected = tsptw_brute_force(dist.tolist(), twe.tolist(), twl.tolist())
    assert ts.maximize().is_exact
    if expected is None:
        assert ts.best_value() is None
        return
    assert ts.best_value() == -expected
    vals, pset = ts.best_solution()
    t, cur = 0, 0
    for j in [int(vals[d]) for d in range(len(dist)) if pset[d]]:
        t = max(t + dist[cur][j], twe[j])
        assert t <= twl[j]
        cur = j
    assert t == expected


@pytest.mark.parametrize("seed", [0, 1])
def test_tsptw_counts_match_ddo_tpu(seed):
    """At batch 1 the search is ddo_tpu's: optimum, bounds, explored and
    expanded counts, supersteps and the tour."""
    js, ts, _ = _tsptw_solvers(seed)
    check_counts(js, ts)


def test_tsptw_width_heuristic_and_compact_route():
    """TsptwWidth grows with depth while the buffer stays the one set at
    construction (the root's width, rounded up), and both extraction
    routes prove one optimum with one trajectory at batch 4."""
    jb, tb = generated_pair(7, seed=3)
    pb = tb.problem
    heu = tt.TsptwWidth(pb.nb_variables, 2)
    sub = tt.root_subproblem(pb)
    assert heu.max_width(sub) == 14
    assert heu.max_width(dataclasses.replace(sub, depth=3)) == 56
    assert tt.Times(3, heu).max_width(sub) == 42 and tt.DivBy(4, heu).max_width(sub) == 3
    runs = []
    for compact in (False, True):
        s = tt.SequentialSolver(tb, width_heu=heu, batch=4, cache=tt.SimpleCache(),
                                cutset_type=tt.FRONTIER, device="cpu",
                                dominance=tt.SimpleDominanceChecker(tts.TsptwDominance(),
                                                                    pb.nb_variables))
        assert s.compiler.width == 16
        s._compact = compact
        assert s.maximize().is_exact
        runs.append((s.best_value(), s.explored_count, s.expanded_nodes))
    assert runs[0] == runs[1]
    dist, twe, twl = pb.dist, pb.twe, pb.twl
    best = tsptw_brute_force(dist.tolist(), twe.tolist(), twl.tolist())
    assert runs[0][0] == -best


def test_width_heuristics_match_ddo_tpu():
    """tests/test_search.py's width cases, and the depth-growing widths of
    TSPTW, SOP and SRFLP, each decorated by `Times` and `DivBy`: the
    port's widths are ddo_tpu's on subproblems at depths 0 to 5."""
    from ddo_tpu.models import sop as jso, srflp as jsr

    n = 6
    heus = [(ddo_tpu.FixedWidth(7), tt.FixedWidth(7)),
            (ddo_tpu.NbUnassignedWidth(n), tt.NbUnassignedWidth(n)),
            (jts.TsptwWidth(n, 2), tt.TsptwWidth(n, 2)),
            (jso.SopWidth(n), tt.SopWidth(n)), (jsr.SrflpWidth(n, 3), tt.SrflpWidth(n, 3))]
    heus += [(ddo_tpu.Times(3, j), tt.Times(3, t)) for j, t in heus]
    heus += [(ddo_tpu.DivBy(4, j), tt.DivBy(4, t)) for j, t in heus]
    for depth in range(6):
        pset = np.arange(n) < depth
        jsub = JSub(state={}, value=0, path_vals=np.zeros(n, np.int32), path_set=pset,
                    ub=0, depth=depth)
        tsub = tt.SubProblem(state={}, value=0, path_vals=np.zeros(n, np.int32),
                             path_set=pset, ub=0, depth=depth)
        for j, t in heus:
            assert t.max_width(tsub) == j.max_width(jsub), (type(t).__name__, depth)
    assert tt.Times(3, tt.FixedWidth(5)).max_width(tsub) == 15
    assert tt.DivBy(2, tt.FixedWidth(10)).max_width(tsub) == 5
    assert tt.DivBy(20, tt.FixedWidth(10)).max_width(tsub) == 1


def test_tsptw_generator_and_scale():
    """The seeded generator: one instance per seed, its random tour
    feasible (so a tour exists), distances scaled x10000 as the parser
    scales them, a 61-node tour far below 2^30."""
    a, b = tts.generate_random(61, 0), tts.generate_random(61, 0)
    assert np.array_equal(a.dist, b.dist) and np.array_equal(a.twe, b.twe)
    assert not np.array_equal(a.dist, tts.generate_random(61, 1).dist)
    assert a.nb_variables == 61 and (a.twe <= a.twl).all()
    assert int(a.twl.max()) < (1 << 30) // 4
    assert tts._scaled("12.5") == 125000 and tts._scaled(0.1) == int(np.float32(0.1) * 10000)


def test_sort_operands_accept_full_width():
    """At 61 nodes (2-word bitsets, 8 state words: Langevin's N60 class) and
    width 256 both sorts take K1's "merge" route, which a compiler built
    for a card accepts; so does the N20 class at width 256, whose two
    sorts (5,376 rows) also take "merge": the register networks end at
    2,048 rows."""
    from ddo_tpu_torch.ops import sort as srt

    for n, nk1, route2 in [(61, 11, "merge"), (21, 8, "merge")]:
        pb = tts.generate_random(n, 0)
        bundle = tp.ModelBundle(pb, tts.TsptwRelax(pb), tts.TsptwRanking())
        _check_sort_operands(bundle, tts.TsptwDominance(), 256)
        assert srt.lane_sort_route(nk1, 256 * n) == "merge"
        assert srt.lane_sort_route(4, 256 * n) == route2
