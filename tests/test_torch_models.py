"""Model parity for misp, max2sat, mcp, golomb and talentsched
(ddo_tpu_torch/models/): every hook against ddo_tpu's under `jax.vmap` on
random reachable states, and the solver's proved optimum against a brute
force, by the compact and by the plane extraction route, with ddo_tpu's
explored and expanded counts at batch 1.  One instance is built from a
numpy seed and crosses into both packages (`from_numpy`); bitset words
cross as `.view` between uint32 and int32.  Tolerance: exact, every value
is an integer or a bool."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import golomb as jgo, max2sat as jms, mcp as jmc, misp as jmi
from ddo_tpu.models import talentsched as jta
from ddo_tpu_torch.core import problem as tp
from ddo_tpu_torch.models import golomb as tgo, max2sat as tms, mcp as tmc, misp as tmi
from ddo_tpu_torch.models import talentsched as tta

from test_max2sat import brute_force as max2sat_brute_force
from test_mcp import brute_force_cut
from test_misp import brute_force as misp_brute_force
from test_talentsched import brute_force as talent_brute_force

MODELS = ["misp", "max2sat", "mcp", "golomb", "talentsched"]
BITSET_LEAVES = {"free", "marks", "dists", "scenes", "maybe"}
B = 16  # walkers of a rollout


# ------------------------------------------------------- one instance, twice
def misp_pair(n=12, seed=0, p=0.35):
    rng = np.random.default_rng(100 + seed)
    edges = [(a, b) for a in range(n) for b in range(a + 1, n) if rng.random() < p]
    weight = rng.integers(1, 10, n)
    jp = jmi.Misp(n, edges, weight)
    pb = tmi.Misp.from_numpy(jp.weight, np.asarray(jp.data["comp_adj"]))
    return (ddo_tpu.ModelBundle(jp, jmi.MispRelax(jp), jmi.MispRanking(jp)),
            tp.ModelBundle(pb, tmi.MispRelax(pb), tmi.MispRanking(pb)),
            dict(edges=edges, weight=weight))


def max2sat_pair(n=7, seed=0):
    rng = np.random.default_rng(200 + seed)
    clauses = {}
    for _ in range(int(rng.integers(2 * n, 3 * n))):
        a = int(rng.integers(1, n + 1)) * (1 if rng.random() < 0.5 else -1)
        b = int(rng.integers(1, n + 1)) * (1 if rng.random() < 0.5 else -1)
        clauses[(min(a, b), max(a, b))] = int(rng.integers(1, 20))
    jp = jms.Max2Sat(n, clauses)
    pb = tms.Max2Sat.from_numpy({k: np.asarray(v) for k, v in jp.data.items()})
    return (ddo_tpu.ModelBundle(jp, jms.Max2SatRelax(jp), jms.Max2SatRanking()),
            tp.ModelBundle(pb, tms.Max2SatRelax(pb), tms.Max2SatRanking()),
            dict(clauses=clauses))


def mcp_pair(n=8, seed=0):
    rng = np.random.default_rng(300 + seed)
    edges = [(a, b, int(rng.integers(-10, 15)))
             for a in range(n) for b in range(a + 1, n) if rng.random() < 0.5]
    jp = jmc.Mcp(n, edges)
    pb = tmc.Mcp.from_numpy(jp.w)
    return (ddo_tpu.ModelBundle(jp, jmc.McpRelax(jp), jmc.McpRanking()),
            tp.ModelBundle(pb, tmc.McpRelax(pb), tmc.McpRanking()), dict(edges=edges))


def golomb_pair(n=5, seed=0):
    jp, pb = jgo.Golomb(n), tgo.Golomb(n)
    return (ddo_tpu.ModelBundle(jp, jgo.GolombRelax(jp), jgo.GolombRanking()),
            tp.ModelBundle(pb, tgo.GolombRelax(pb), tgo.GolombRanking()), {})


def talentsched_pair(n=5, seed=0, A=4):
    rng = np.random.default_rng(1200 + seed)
    actors = (rng.random((A, n)) < 0.5).astype(np.int64)
    for s in range(n):  # every scene needs at least one actor
        if actors[:, s].sum() == 0:
            actors[rng.integers(0, A), s] = 1
    jp = jta.TalentSched(n, A, rng.integers(1, 9, A), rng.integers(1, 5, n), actors)
    pb = tta.TalentSched.from_numpy(jp.cost, jp.duration, jp.actor_mat)
    return (ddo_tpu.ModelBundle(jp, jta.TalentSchedRelax(jp), jta.TalentSchedRanking()),
            tp.ModelBundle(pb, tta.TalentSchedRelax(pb), tta.TalentSchedRanking()), {})


PAIRS = dict(misp=misp_pair, max2sat=max2sat_pair, mcp=mcp_pair, golomb=golomb_pair,
             talentsched=talentsched_pair)


def to_jax_state(state):
    """A port state (numpy or torch leaves, int32 words) as ddo_tpu's."""
    out = {}
    for k, v in state.items():
        a = np.ascontiguousarray(v.numpy() if torch.is_tensor(v) else np.asarray(v))
        out[k] = jnp.asarray(a.view(np.uint32) if k in BITSET_LEAVES else a)
    return out


def assert_state_equal(jstate, tstate, msg=""):
    for k in jstate:
        j = np.ascontiguousarray(np.asarray(jstate[k]))
        t = tstate[k].numpy() if torch.is_tensor(tstate[k]) else np.asarray(tstate[k])
        if k in BITSET_LEAVES:
            j = j.view(np.int32)
        np.testing.assert_array_equal(j, t, err_msg=f"{msg} {k}")


# ------------------------------------------------------------- hook parity
@functools.lru_cache(maxsize=None)
def rollout(name):
    """[(depth, states [B, ...], var [B])]: B random walks of the port's
    own `step` from the root, so every state is reachable."""
    jb, tb, _ = PAIRS[name]()
    pb = tb.problem
    data = pb.data("cpu")
    n = pb.nb_variables
    rng = np.random.default_rng(7)
    st = {k: torch.as_tensor(np.stack([np.asarray(v)] * B))
          for k, v in pb.initial_state().items()}
    assigned = np.zeros((B, n), bool)
    order = pb.var_order()
    rows = np.arange(B)
    layers = []
    for depth in range(n):
        if order is None:
            var = np.asarray([rng.choice(np.flatnonzero(~assigned[b])) for b in range(B)])
        else:
            var = np.full(B, order[depth])
        layers.append((depth, st, var))
        nstate, _, _, valid = pb.step(data, st, torch.as_tensor(var), depth)
        valid = valid.numpy()
        pick = np.asarray([rng.choice(np.flatnonzero(valid[b])) if valid[b].any() else -1
                           for b in range(B)])
        moved = torch.as_tensor(pick >= 0)
        st = {k: torch.where(moved.reshape((B,) + (1,) * (st[k].dim() - 1)),
                             nstate[k][rows, np.maximum(pick, 0)], st[k]) for k in st}
        assigned[rows, var] = True
    return jb, tb, layers


@pytest.mark.parametrize("name", MODELS)
def test_step_matches(name):
    """`step` on every (state, domain slot) of the rollout: next state,
    cost, decision value and validity.  For golomb this holds the direct
    bit indexing against ddo_tpu's reverse-and-shift window."""
    jb, tb, layers = rollout(name)
    jp, pb = jb.problem, tb.problem
    D = pb.domain_size
    for depth, st, var in layers:
        nstate, cost, dval, valid = pb.step(pb.data("cpu"), st, torch.as_tensor(var), depth)
        jn, jc, jd, jv = jax.vmap(lambda s, v: jax.vmap(
            lambda d: jp.step(jp.data, s, v, d, depth))(jnp.arange(D, dtype=jnp.int32))
        )(to_jax_state(st), jnp.asarray(var, jnp.int32))
        assert_state_equal(jn, nstate, f"depth {depth}")
        assert cost.dtype == dval.dtype == torch.int32 and valid.dtype == torch.bool
        np.testing.assert_array_equal(np.asarray(jc), cost.numpy())
        np.testing.assert_array_equal(np.asarray(jd), dval.numpy())
        np.testing.assert_array_equal(np.broadcast_to(np.asarray(jv), valid.shape),
                                      valid.numpy())


@pytest.mark.parametrize("name", MODELS)
def test_pack_score_rub_match(name):
    jb, tb, layers = rollout(name)
    jp, pb = jb.problem, tb.problem
    for depth, st, _ in layers:
        js = to_jax_state(st)
        np.testing.assert_array_equal(np.asarray(jax.vmap(jp.pack)(js)),
                                      pb.pack(st).numpy())
        score = tb.ranking.score(tb.ranking.data("cpu"), st)
        ref = jax.vmap(lambda s: jnp.atleast_1d(jb.ranking.score(jb.ranking.data, s)))(js)
        assert score.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ref), score.numpy())
        rub = tb.relaxation.rub(tb.relaxation.data("cpu"), st, depth)
        ref = jax.vmap(lambda s: jb.relaxation.rub(jb.relaxation.data, s, depth))(js)
        assert rub.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ref), rub.numpy(), err_msg=f"rub {depth}")
    # unpack inverts pack on the host
    st = layers[-1][1]
    back = pb.unpack(pb.pack(st)[3].numpy())
    assert_state_equal({k: v[3].numpy() for k, v in st.items()},
                       {k: np.asarray(v) for k, v in back.items()})


@pytest.mark.parametrize("name", MODELS)
def test_merge_and_relax_cost_match(name):
    """`merge` of a random subset of each layer's states (and of the empty
    subset), then `relax_cost` of every state redirected to the merged
    node."""
    jb, tb, layers = rollout(name)
    rng = np.random.default_rng(3)
    rdata = tb.relaxation.data("cpu")
    for depth, st, var in layers:
        js = to_jax_state(st)
        for mask in (rng.random(B) < 0.5, np.zeros(B, bool)):
            merged = tb.relaxation.merge(rdata, {k: v[None] for k, v in st.items()},
                                         torch.as_tensor(mask)[None])
            jm = jb.relaxation.merge(jb.relaxation.data, js, jnp.asarray(mask))
            assert_state_equal(jm, {k: v[0] for k, v in merged.items()}, f"merge {depth}")
        cost = rng.integers(-50, 50, B).astype(np.int32)
        dval = rng.integers(0, 2, B).astype(np.int32)
        src = {k: v.roll(1, 0) for k, v in st.items()}
        got = tb.relaxation.relax_cost(
            rdata, src, st, {k: v.expand((B,) + tuple(v.shape[1:])) for k, v in merged.items()},
            torch.as_tensor(dval), torch.as_tensor(cost), torch.as_tensor(var))
        ref = jax.vmap(lambda s, d, dv, c, v: jb.relaxation.relax_cost(
            jb.relaxation.data, s, d, jm, dv, c, v))(
            to_jax_state(src), js, jnp.asarray(dval), jnp.asarray(cost),
            jnp.asarray(var, jnp.int32))
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_misp_next_variable_and_is_impacted_match():
    """The dynamic order, one variable per lane (K=2 lanes of W=8 rows,
    random masks, an all-empty layer for the fallback), first index on
    ties; and the long-arc predicate."""
    jb, tb, layers = rollout("misp")
    jp, pb = jb.problem, tb.problem
    rng = np.random.default_rng(5)
    K, W = 2, B // 2
    for depth, st, var in layers:
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(lambda s, v: jp.is_impacted_by(jp.data, s, v))(
                to_jax_state(st), jnp.asarray(var, jnp.int32))),
            pb.is_impacted_by(pb.data("cpu"), st, torch.as_tensor(var)).numpy())
        lanes = {"free": st["free"].view(K, W, -1)}
        assigned = rng.random((K, pb.nb_variables)) < depth / pb.nb_variables
        assigned[:, -1] = False
        for mask in (rng.random((K, W)) < 0.6, np.zeros((K, W), bool)):
            got = pb.next_variable(pb.data("cpu"), depth, lanes, torch.as_tensor(mask),
                                   torch.as_tensor(assigned))
            ref = [jp.next_variable(jp.data, depth, to_jax_state({"free": lanes["free"][k]}),
                                    jnp.asarray(mask[k]), jnp.asarray(assigned[k]))
                   for k in range(K)]
            assert got.dtype == torch.int64 and got.shape == (K,)
            np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # ties: two vertices in the same single state -> the first one
    free = torch.zeros((1, 1, 1), dtype=torch.int32)
    free[0, 0, 0] = 0b101000
    one = pb.next_variable(pb.data("cpu"), 0, {"free": free},
                           torch.ones((1, 1), dtype=torch.bool),
                           torch.zeros((1, pb.nb_variables), dtype=torch.bool))
    assert int(one[0]) == 3


# ----------------------------------------------------- solver vs brute force
def _solver(bundle, compact, **kw):
    s = tt.SequentialSolver(bundle, device="cpu", **kw)
    s._compact = compact
    return s


def _prove(bundle, expected, **kw):
    """Both extraction routes prove `expected`, with one trajectory."""
    runs = []
    for compact in (False, True):
        s = _solver(bundle, compact, **kw)
        assert s.maximize().is_exact
        assert s.best_value() == expected, (compact, s.best_value(), expected)
        runs.append((s.explored_count, s.expanded_nodes, s.stats.supersteps))
    assert runs[0] == runs[1], runs
    return s


@pytest.mark.parametrize("seed", range(5))
def test_misp_random_vs_bruteforce(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 13))
    _, tb, inst = misp_pair(n, seed)
    expected = misp_brute_force(n, inst["edges"], inst["weight"])
    s = _prove(tb, expected, width_heu=tt.FixedWidth(int(rng.integers(2, 6))),
               batch=int(rng.integers(1, 4)), cutset_type=tt.LAST_EXACT_LAYER)
    vals, pset = s.best_solution()
    chosen = [i for i in range(n) if pset[i] and vals[i] == 1]
    adj = {frozenset(e) for e in inst["edges"]}
    assert not any(frozenset((a, b)) in adj for a in chosen for b in chosen if a != b)
    assert sum(int(inst["weight"][i]) for i in chosen) == expected


@pytest.mark.parametrize("seed", range(4))
def test_max2sat_random_vs_bruteforce(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 9))
    _, tb, inst = max2sat_pair(n, seed)
    expected = max2sat_brute_force(n, inst["clauses"])
    _prove(tb, expected, width_heu=tt.FixedWidth(int(rng.integers(2, 6))),
           batch=int(rng.integers(1, 4)), cache=tt.SimpleCache())


@pytest.mark.parametrize("seed", range(4))
def test_mcp_random_vs_bruteforce(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 10))
    _, tb, _ = mcp_pair(n, seed)
    expected = brute_force_cut(n, tb.problem.w)
    _prove(tb, expected, width_heu=tt.FixedWidth(int(rng.integers(2, 6))),
           batch=int(rng.integers(1, 4)), cache=tt.SimpleCache(), cutset_type=tt.FRONTIER)


@pytest.mark.parametrize("seed", range(4))
def test_talentsched_random_vs_bruteforce(seed):
    rng = np.random.default_rng(seed)
    _, tb, _ = talentsched_pair(int(rng.integers(3, 6)), seed, A=int(rng.integers(2, 5)))
    expected = talent_brute_force(tb.problem)
    s = _prove(tb, -expected, width_heu=tt.FixedWidth(int(rng.integers(2, 8))), batch=2,
               cache=tt.SimpleCache(), cutset_type=tt.FRONTIER)
    vals, pset = s.best_solution()
    assert pset.all() and sorted(vals) == list(range(tb.problem.nb_variables))


@pytest.mark.parametrize("n,opt", [(2, 1), (3, 3), (4, 6), (5, 11)])
def test_golomb_known_optima(n, opt):
    _, tb, _ = golomb_pair(n)
    s = _prove(tb, -opt, width_heu=tt.FixedWidth(10), cache=tt.SimpleCache(),
               cutset_type=tt.FRONTIER)
    vals, pset = s.best_solution()
    marks = [0] + sorted(int(v) for v, p in zip(vals, pset) if p)
    dists = [b - a for i, a in enumerate(marks) for b in marks[i + 1:]]
    assert len(marks) == n and len(set(dists)) == len(dists) and max(marks) == opt


@pytest.mark.parametrize("name", MODELS)
def test_counts_match_ddo_tpu_at_batch_1(name):
    """The same search trajectory as ddo_tpu's solver on the rollout's
    instance at batch 1 (plane route on both sides): optimum, bounds,
    explored, expanded, supersteps, and the solution itself."""
    jb, tb, _ = rollout(name)
    kw = dict(batch=1, buffer_width=16)  # golomb's first layer holds D=14 nodes
    js = ddo_tpu.SequentialSolver(jb, width_heu=ddo_tpu.FixedWidth(3),
                                  cache=ddo_tpu.SimpleCache(),
                                  cutset_type=ddo_tpu.FRONTIER, **kw)
    ts = _solver(tb, False, width_heu=tt.FixedWidth(3), cache=tt.SimpleCache(),
                 cutset_type=tt.FRONTIER, **kw)
    assert js.maximize().is_exact and ts.maximize().is_exact
    assert js._compact is False
    assert ts.best_value() == js.best_value()
    assert ts.best_upper_bound() == js.best_upper_bound()
    assert (ts.explored_count, ts.expanded_nodes, ts.stats.supersteps) == \
        (js.explored_count, js.expanded_nodes, js.stats.supersteps)
    for a, b in zip(js.best_solution(), ts.best_solution()):
        np.testing.assert_array_equal(a, b)


def test_too_many_sort_operands_raises_at_construction():
    """A model whose sorts are beyond the lane sort kernel (more operands
    than one call takes, MAX_OPERANDS = 512) is refused when a compiler is
    built for a card:
    never a silent fall back to the plain version there.  The check needs
    no card, and the CPU route, whose plain sort has no such limit, takes
    the same models.  Lanes too long for one block's shared memory are no
    longer refused: K1's "merge" route takes them."""
    from ddo_tpu_torch.engine.mdd import _check_sort_operands
    from ddo_tpu_torch.ops import sort as srt

    # 256 state words: 259 keys, 257 ranking columns, the long-arc flag
    pb = tmi.Misp(256 * 32, [])
    bundle = tp.ModelBundle(pb, tmi.MispRelax(pb), tmi.MispRanking(pb))
    assert srt.MAX_OPERANDS == 512
    with pytest.raises(ValueError, match="519 sort operands"):
        _check_sort_operands(bundle, None, 8)
    tt.DDCompiler(bundle, 8, device="cpu")
    # golomb's domain is wide: 12 marks give 73 values and 14 key words,
    # so 256 nodes make lanes of 18,688 candidates, on the "merge" route
    pb = tgo.Golomb(12)
    bundle = tp.ModelBundle(pb, tgo.GolombRelax(pb), tgo.GolombRanking())
    _check_sort_operands(bundle, None, 256)
    assert srt.lane_sort_route(3 + 14, 256 * 73) == "merge"
    _check_sort_operands(bundle, None, 16)
    tt.DDCompiler(bundle, 256, device="cpu")


def test_generators_and_exports():
    """The seeded generators give one instance per seed, and the package
    exports what ddo_tpu's `__init__` does (the Pooled solver aliases,
    the Times / DivBy width heuristics and the mesh included)."""
    a, ea = tmi.generate_gnp(30, 0.2, seed=1)
    b, eb = tmi.generate_gnp(30, 0.2, seed=1)
    assert ea == eb and np.array_equal(a.comp_adj, b.comp_adj)
    assert tmi.generate_gnp(30, 0.2, seed=2)[1] != ea
    m, clauses = tms.generate_random(10, 30, seed=1)
    assert m.nb_variables == 10 and 0 < len(clauses) <= 30
    g, edges = tmc.generate_random(10, 0.5, seed=1)
    assert g.nb_variables == 10 and all(w != 0 for _, _, w in edges)
    t = tta.generate_random(6, 3, seed=1)
    assert t.actor_mat.shape == (3, 6) and (t.actor_mat.sum(axis=1) > 0).all()
    # every name ddo_tpu exports, the mesh's included
    missing = set(ddo_tpu.__all__) - set(tt.__all__)
    assert not missing, missing
