"""DeviceLoopSolver parity (ddo_tpu_torch/search/device_loop.py): the
port's `DeviceLoopSolver(device="cpu")` against ddo_tpu's on the same
generated knapsack instances, with equal best value, best upper bound,
solution, explored and expanded counts, supersteps and `loop_events`;
the width descriptors; and the two documented divergences from ddo_tpu
(ROADMAP C.8 and C.9), each shown by its own test.  Tolerance: exact,
every value is an integer or a bool."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.core.types import SubProblem as JSub
from ddo_tpu.models import knapsack as jk
from ddo_tpu.models.tsptw import TsptwWidth as JTsptwWidth
from ddo_tpu.search import device_loop as jdl
from ddo_tpu_torch.models import knapsack as tk
from ddo_tpu_torch.search import device_loop as tdl


def kp_pair(seed=17, n=14, correlated=False):
    """One knapsack in both packages: seed 17's 14 items of capacity 60
    (tests/test_torch_solver.py), or a correlated instance (profit =
    weight + 0..5, capacity half the weight) that keeps many nodes open."""
    rng = np.random.default_rng(seed)
    if correlated:
        w = rng.integers(10, 40, n)
        p = w + rng.integers(0, 6, n)
        jp = jk.Knapsack(int(w.sum() // 2), p, w)
    else:
        jp = jk.Knapsack(60, rng.integers(1, 50, n), rng.integers(1, 20, n))
    pb = tk.Knapsack.from_numpy(jp.capacity, jp.profit, jp.weight)
    return (ddo_tpu.ModelBundle(jp, jk.KPRelax(jp), jk.KPRanking()),
            tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking()))


def knobs(pkg, cache=True, cutset="FRONTIER", width=2, dom=None, **kw):
    """The same solver settings in `pkg` (ddo_tpu or ddo_tpu_torch)."""
    out = dict(width_heu=pkg.FixedWidth(width), cutset_type=pkg.CutsetType[cutset],
               cache=pkg.SimpleCache() if cache else pkg.EmptyCache(), **kw)
    if dom is not None:
        out["dominance"] = pkg.SimpleDominanceChecker(dom[0], dom[1])
    if pkg is tt:
        out["device"] = "cpu"
    return out


def run_pair(jb, tb, jkw, tkw, primal=None):
    js = ddo_tpu.DeviceLoopSolver(jb, **jkw)
    ts = tt.DeviceLoopSolver(tb, **tkw)
    if primal is not None:
        for s in (js, ts):
            s.set_primal(*primal)
    return js, js.maximize(), ts, ts.maximize()


def assert_same_run(js, jc, ts, tc):
    assert tc.is_exact == jc.is_exact and tc.best_value == jc.best_value
    assert ts.best_value() == js.best_value()
    assert ts.best_upper_bound() == js.best_upper_bound()
    assert ts.best_lower_bound() == js.best_lower_bound()
    assert (ts.explored_count, ts.expanded_nodes, ts.stats.supersteps) == \
        (js.explored_count, js.expanded_nodes, js.stats.supersteps)
    assert ts.loop_events == js.loop_events
    if js.best_solution() is None:
        assert ts.best_solution() is None
    else:
        for a, b in zip(js.best_solution(), ts.best_solution()):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_seed17_knapsack_counts():
    """ddo_tpu's counts on seed 17: 261, 33 explored, 366 expanded, 9
    supersteps, 2 chunks and one seed."""
    jb, tb = kp_pair()
    loop = dict(batch=4, slab_cap=128, chunk_steps=6, cut_cap=32)
    js, jc, ts, tc = run_pair(jb, tb, knobs(ddo_tpu, **loop), knobs(tt, **loop))
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.best_value() == 261
    assert (ts.explored_count, ts.expanded_nodes, ts.stats.supersteps) == (33, 366, 9)
    assert ts.loop_events == dict(chunks=2, cutov=0, full=0, seeds=1)
    vals, pset = ts.best_solution()
    take = (vals == 1) & pset
    assert (tb.problem.profit * take).sum() == 261
    assert (tb.problem.weight * take).sum() <= tb.problem.capacity


def test_knapsack_with_dominance_counts():
    jb, tb = kp_pair(8, 20, correlated=True)
    n = tb.problem.nb_variables
    loop = dict(batch=4, slab_cap=128, chunk_steps=4, cut_cap=32)
    js, jc, ts, tc = run_pair(
        jb, tb, knobs(ddo_tpu, cutset="LAST_EXACT_LAYER", dom=(jk.KPDominance(), n), **loop),
        knobs(tt, cutset="LAST_EXACT_LAYER", dom=(tk.KPDominance(), n), **loop))
    assert_same_run(js, jc, ts, tc)
    pb = tb.problem
    assert tc.is_exact and ts.best_value() == tk.dp_optimum(pb.capacity, pb.profit, pb.weight)
    assert ts.stats.supersteps > 1


def test_tiny_slab_forces_spill_replay_and_reseed():
    """An 8-row slab with a 4-row cut cap: slab-full drains, cutset
    overflows replayed through the host path and fringe reseeds all
    happen, with ddo_tpu's counts."""
    jb, tb = kp_pair(8, 20, correlated=True)
    loop = dict(batch=2, slab_cap=8, chunk_steps=4, cut_cap=4)
    js, jc, ts, tc = run_pair(jb, tb, knobs(ddo_tpu, **loop), knobs(tt, **loop))
    assert_same_run(js, jc, ts, tc)
    ev = ts.loop_events
    assert ev["full"] >= 1 and ev["cutov"] >= 1 and ev["seeds"] >= 2, ev
    pb = tb.problem
    assert tc.is_exact and ts.best_value() == tk.dp_optimum(pb.capacity, pb.profit, pb.weight)


def test_time_budget_zero_aborts_with_valid_bounds():
    jb, tb = kp_pair()
    loop = dict(batch=4, slab_cap=128, chunk_steps=4, cut_cap=32)
    js, jc, ts, tc = run_pair(jb, tb, knobs(ddo_tpu, cutoff=ddo_tpu.TimeBudget(0.0), **loop),
                              knobs(tt, cutoff=tt.TimeBudget(0.0), **loop))
    assert not tc.is_exact and not jc.is_exact
    assert ts.gap() == js.gap() == 1.0
    assert ts.best_upper_bound() == js.best_upper_bound() >= ts.best_lower_bound()
    assert ts.loop_events == js.loop_events


def test_set_primal_closes_with_ddo_tpus_counts():
    jb, tb = kp_pair()
    n = tb.problem.nb_variables
    primal = (261, (np.zeros(n, np.int32), np.zeros(n, bool)))
    loop = dict(batch=4, slab_cap=128, chunk_steps=4, cut_cap=32)
    js, jc, ts, tc = run_pair(jb, tb, knobs(ddo_tpu, **loop), knobs(tt, **loop), primal)
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.best_lower_bound() == 261
    assert ts.explored_count < 33  # the warm start prunes


def test_width_static_descriptors():
    """Every width heuristic the reference CI uses evaluates on the device
    as on the host, with ddo_tpu's descriptor and values."""
    n = 10
    depth = np.asarray([0, 3, 7])
    pset = np.zeros((3, n), bool)
    pset[1, :3] = pset[2, :7] = True

    def host(heu, d, k):
        sub = tt.SubProblem(state=None, value=0, path_vals=np.zeros(n, np.int32),
                            path_set=np.arange(n) < k, ub=0, depth=d)
        return heu.max_width(sub)

    cases = [(tt.FixedWidth(5), ddo_tpu.FixedWidth(5)),
             (tt.NbUnassignedWidth(n), ddo_tpu.NbUnassignedWidth(n)),
             (tt.Times(3, tt.NbUnassignedWidth(n)), ddo_tpu.Times(3, ddo_tpu.NbUnassignedWidth(n))),
             (tt.DivBy(2, tt.NbUnassignedWidth(n)), ddo_tpu.DivBy(2, ddo_tpu.NbUnassignedWidth(n))),
             (tt.TsptwWidth(n, 2), JTsptwWidth(n, 2)),
             (tt.SopWidth(n, 1), JTsptwWidth(n, 1)),
             (tt.SrflpWidth(n, 3), JTsptwWidth(n, 3))]
    for theu, jheu in cases:
        desc = tdl.width_static(theu)
        assert desc == jdl.width_static(jheu)
        got = tdl._eval_width(desc, torch.as_tensor(depth), torch.as_tensor(pset))
        want = np.asarray(jdl._eval_width(desc, jnp.asarray(depth), jnp.asarray(pset)))
        assert got.dtype == torch.int32
        assert got.tolist() == want.tolist() == [host(theu, d, k) for d, k in
                                                 [(0, 0), (3, 3), (7, 7)]]


def test_lookalike_width_heuristic_is_refused():
    """C.9: ddo_tpu takes any heuristic with `nb_vars` and `factor`
    attributes for a TSPTW-style width; the port matches the classes and
    raises for anything else."""

    class LookAlike(tt.WidthHeuristic):
        nb_vars, factor = 10, 2

        def max_width(self, sub):
            return 7  # not nb_vars * (depth + 1) * factor

    assert jdl.width_static(LookAlike()) == ("lineardepth", 10, 2)
    with pytest.raises(TypeError, match="LookAlike"):
        tdl.width_static(LookAlike())
    _, tb = kp_pair()
    with pytest.raises(TypeError, match="no device evaluation"):
        tt.DeviceLoopSolver(tb, width_heu=LookAlike(), device="cpu")


def _dedup_fixture(pkg, solver):
    """An 8-row slab with 7 active rows, so the chunk's dedup fires: row 0
    (ub 1000, popped first), five distinct depth-1 rows, row 6 (depth 3,
    capacity 30, ub 200), and row 7, INACTIVE, with row 6's depth and
    state and ub 900."""
    n = solver.problem.nb_variables
    Sub = JSub if pkg is ddo_tpu else tt.SubProblem
    rows = [(1, 50, 1000, 10)] + [(1, 40 + i, 100, 10) for i in range(5)] \
        + [(3, 30, 200, 5), (3, 30, 900, 5)]
    subs = [Sub(state={"capacity": np.asarray(c, np.int32)}, value=v,
                path_vals=np.zeros(n, np.int32), path_set=np.arange(n) < d, ub=u, depth=d)
            for d, c, u, v in rows]
    root = solver.problem.initial_state() if pkg is tt else subs[0].state
    slab = solver._seed_slab(solver._empty_slab(root), subs)
    if pkg is ddo_tpu:
        act = slab["act"].at[7].set(False)
        best = dict(lb=jnp.asarray(tt.NEG_INF, jnp.int32), vals=jnp.zeros(n, jnp.int32),
                    set=jnp.zeros(n, bool), has=jnp.asarray(False))
    else:
        act = slab["act"].clone()
        act[7] = False
        best = dict(lb=torch.tensor(tt.NEG_INF, dtype=torch.int32),
                    vals=torch.zeros(n, dtype=torch.int32),
                    set=torch.zeros(n, dtype=torch.bool), has=torch.tensor(False))
    return dict(slab, act=act), best


def test_dedup_runs_stop_at_inactive_rows():
    """C.8: ddo_tpu's slab dedup lets the trailing inactive row join the
    last active run, so row 6's merged ub becomes the dead row's 900; the
    port's runs end at the active/inactive boundary and row 6 keeps the
    max over active rows, 200.  One superstep of each package's chunk."""
    jb, tb = kp_pair()
    kw = dict(batch=1, slab_cap=8, chunk_steps=1, cut_cap=4)
    js = ddo_tpu.DeviceLoopSolver(jb, **knobs(ddo_tpu, cache=False, **kw))
    ts = tt.DeviceLoopSolver(tb, **knobs(tt, cache=False, **kw))
    jt = ddo_tpu.CompilationType
    slab, best = _dedup_fixture(ddo_tpu, js)
    jslab, jbest, _, _, jst = jdl._device_chunk(
        js.compiler._specs[jt.RESTRICTED], js.compiler._specs[jt.RELAXED],
        js.bundle.datas, slab, best, jnp.asarray(1, jnp.int32), None, None,
        wdesc=js._wdesc, start_layer=0, Pcut=js.cut_cap)
    slab, best = _dedup_fixture(tt, ts)
    tslab, tbest, _, _, tst = tdl.device_chunk(
        ts.compiler._specs[tt.CompilationType.RESTRICTED],
        ts.compiler._specs[tt.CompilationType.RELAXED], ts.compiler.datas, ts._order,
        slab, best, 1, None, None, K=1, wdesc=ts._wdesc, start=1, Pcut=ts.cut_cap)
    assert int(jst["steps"]) + int(jst["full"]) + int(jst["cutov"]) == 1
    assert int(tst["steps"]) == int(jst["steps"])
    assert int(jslab["ub"][6]) == 900
    assert int(tslab["ub"][6]) == 200
    # every other row agrees; row 6 stays open in ddo_tpu only while the
    # inflated ub beats the superstep's incumbent
    rest = [i for i in range(8) if i != 6]
    assert np.asarray(jslab["ub"])[rest].tolist() == tslab["ub"][rest].tolist()
    assert np.asarray(jslab["act"])[rest].tolist() == tslab["act"][rest].tolist()
    lb = int(tbest["lb"])
    assert lb == int(jbest["lb"])
    assert bool(jslab["act"][6]) == (900 > lb) and bool(tslab["act"][6]) == (200 > lb)


def test_compaction_helpers_match_a_stable_argsort():
    rng = np.random.default_rng(0)
    for N, P in [(1, 1), (17, 4), (64, 64), (100, 7)]:
        mask = torch.as_tensor(rng.random(N) < 0.4)
        perm = tdl._partition(mask)
        want = torch.argsort((~mask).to(torch.int32), stable=True)
        assert perm.tolist() == want.tolist()
        idx, count = tdl._compact(mask, P)
        m = min(int(mask.sum()), P)
        assert int(count) == int(mask.sum())
        assert idx[:m].tolist() == want[:m].tolist()


def test_arguments_are_checked_and_the_card_is_the_default():
    _, tb = kp_pair()
    with pytest.raises(ValueError, match="cut_cap"):
        tt.DeviceLoopSolver(tb, slab_cap=16, cut_cap=9, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        tt.DeviceLoopSolver(tb, batch=32, slab_cap=16, cut_cap=8, device="cpu")
    if torch.cuda.is_available():
        assert tt.DeviceLoopSolver(tb).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.DeviceLoopSolver(tb)
