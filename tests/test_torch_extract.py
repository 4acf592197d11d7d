"""Device-side row extraction (ddo_tpu_torch/engine/extract.py):
`cache_rows`, `exact_rows` and `cutset_rows` against ddo_tpu's functions
on the same planes and against the plane route's per-lane row sets (same
rows, same order); the solver's compact route against its plane route on
generated knapsack and MISP instances (the mirror of tests/test_extract.py
without instance files); and the cutset-cap overflow fallback on a
generated mcp instance.  Exact: every value is an integer or a bool.

The divergence tests/test_extract.py:9-17 allows holds here too: the
compact route enqueues the cutset after every lane's incumbent is in, so
it may prune more rows than the plane route when an incumbent lands
mid-drain.  The fixtures below are ones where it does not."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu_torch as tt
from ddo_tpu.engine import extract as JEX
from ddo_tpu_torch.engine import extract as EX
from ddo_tpu_torch.models import knapsack as tk
from ddo_tpu_torch.utils.num import NEG_INF

from test_torch_models import mcp_pair, misp_pair

M = 4096


def _compiled(kind):
    """(relaxed CompiledBatch, actives): four lanes, the last inactive."""
    if kind == "knapsack":
        pb = tk.generate_uncorrelated(14, 50, 1, 3, seed=3)
        bundle = tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())
        dom = tk.KPDominance()
    else:
        _, bundle, _ = misp_pair(14, seed=2)
        dom = None
    c = tt.DDCompiler(bundle, 8, tt.FRONTIER, dominance=dom, device="cpu")
    root = tt.root_subproblem(bundle.problem)
    batch = c.compile_batch(tt.CompilationType.RELAXED, [root] * 4, NEG_INF, [2, 3, 4, 3])
    return batch, torch.tensor([True, True, True, False])


def _j(t):
    return jnp.asarray(t.numpy())


def _assert_rows(ref, got, names):
    """ddo_tpu's fixed-M rows, cut at its count, against the port's."""
    cnt = int(ref["count"])
    assert cnt == got["count"] and 0 < cnt <= M
    for name in names:
        np.testing.assert_array_equal(np.asarray(ref[name])[:cnt], got[name].numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("kind", ["knapsack", "misp"])
def test_cache_rows_match(kind):
    batch, act = _compiled(kind)
    d = batch.dev
    args = [d[k] for k in ("has_theta", "above", "cutflag", "wl_unexplored", "theta", "keys")]
    got = EX.cache_rows(*args, act, M=M)
    ref = JEX.cache_rows(*[_j(a) for a in args], _j(act), M=M)
    _assert_rows(ref, got, ("depths", "keys", "thetas", "explored"))
    # the plane route's rows, lane after lane
    lanes = [dd.cache_batch() for dd in list(batch)[:3]]
    for i, name in enumerate(("depths", "keys", "thetas", "explored")):
        np.testing.assert_array_equal(np.concatenate([l[i] for l in lanes]),
                                      got[name].numpy(), err_msg=name)


def test_exact_rows_match():
    batch, act = _compiled("knapsack")
    d = batch.dev
    args = [d[k] for k in ("exact", "mask", "value", "dkey", "dcoord")]
    got = EX.exact_rows(*args, act, M=M)
    ref = JEX.exact_rows(*[_j(a) for a in args], _j(act), M=M)
    _assert_rows(ref, got, ("depths", "dkeys", "dcoords", "values"))
    lanes = [dd.exact_nodes_batch() for dd in list(batch)[:3]]
    for i, name in enumerate(("depths", "dkeys", "dcoords", "values")):
        np.testing.assert_array_equal(np.concatenate([l[i] for l in lanes]),
                                      got[name].numpy(), err_msg=name)


@pytest.mark.parametrize("kind", ["knapsack", "misp"])
def test_cutset_rows_match(kind):
    batch, act = _compiled(kind)
    d = batch.dev
    with_dom = "dkey" in d
    zcols = d["keys"][:, :, :0, :]
    args = [d[k] for k in ("cutflag", "marked", "value", "rub", "value_bot", "rank0",
                           "keys", "best_value", "feasible")] \
        + [d.get("dkey", zcols), d.get("dcoord", zcols)]
    got = EX.cutset_rows(*args, act, M=M, with_dom=with_dom)
    ref = JEX.cutset_rows(*[_j(a) for a in args], _j(act), M=M, with_dom=with_dom)
    names = ("lanes", "layers", "slots", "keys", "values", "ubs", "scores") \
        + (("dkeys", "dcoords") if with_dom else ())
    _assert_rows(ref, got, names)
    lanes = [dd.cutset_batch(with_dom=with_dom) for dd in list(batch)[:3]]
    plane = dict(keys=0, layers=1, values=2, ubs=3, scores=6)
    if with_dom:
        plane.update(dkeys=7, dcoords=8)
    for name, i in plane.items():
        np.testing.assert_array_equal(np.concatenate([l[i] for l in lanes]),
                                      got[name].numpy(), err_msg=name)
    np.testing.assert_array_equal(
        np.concatenate([np.full(len(l[1]), k) for k, l in enumerate(lanes)]),
        got["lanes"].numpy())


def test_caps_cut_rows_and_keep_the_true_count():
    batch, act = _compiled("knapsack")
    d = batch.dev
    full = EX.cache_rows(d["has_theta"], d["above"], d["cutflag"], d["wl_unexplored"],
                         d["theta"], d["keys"], act, M=M)
    cut = EX.cache_rows(d["has_theta"], d["above"], d["cutflag"], d["wl_unexplored"],
                        d["theta"], d["keys"], act, M=5)
    assert cut["count"] == full["count"] > 5 and len(cut["depths"]) == 5
    np.testing.assert_array_equal(cut["keys"].numpy(), full["keys"].numpy()[:5])
    # the cache and dominance caps are ddo_tpu's; the cutset's is every row
    # of the batch, so a full batch never overflows it
    for K, n1, W in [(128, 201, 256), (1, 5, 8), (128, 62, 256)]:
        assert EX.extract_caps(K, n1, W)[:2] == JEX.extract_caps(K, n1, W)[:2]
        assert EX.extract_caps(K, n1, W)[2] == K * n1 * W


def test_prefetch_on_the_cpu_is_the_tensors_own_memory():
    t = torch.arange(6, dtype=torch.int32)
    out = EX.prefetch({"a": t, "n": 3, "d": {"b": t.bool()}})
    assert out["n"] == 3 and np.shares_memory(out["a"], t.numpy())
    np.testing.assert_array_equal(out["d"]["b"], [False] + [True] * 5)


# ------------------------------------------ the solver's two routes, end to end
def _solve(make_solver, compact):
    solver = make_solver()
    assert solver._compact is False  # the CPU default
    solver._compact = compact
    completion = solver.maximize()
    return (solver.best_value(), completion.is_exact, solver.explored_count,
            solver.expanded_nodes, solver.stats.supersteps, solver.best_solution())


def _assert_equiv(make_solver):
    plane = _solve(make_solver, False)
    compact = _solve(make_solver, True)
    assert plane[:5] == compact[:5]
    assert plane[0] is not None
    np.testing.assert_array_equal(plane[5][0], compact[5][0])
    np.testing.assert_array_equal(plane[5][1], compact[5][1])
    return plane


@pytest.mark.parametrize("chunked", [False, True])
def test_compact_equivalence_knapsack(chunked):
    """Frontier cutsets, cache and dominance, on the fused route and on the
    two-pass (chunked) route."""
    pb = tk.generate_uncorrelated(23, 100, 1, 3, seed=8)
    bundle = tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())
    extra = dict(cutoff=tt.TimeBudget(3600), compile_chunk=8) if chunked else {}
    plane = _assert_equiv(lambda: tt.SequentialSolver(
        bundle, width_heu=tt.FixedWidth(2), batch=4, cache=tt.SimpleCache(),
        cutset_type=tt.FRONTIER, device="cpu",
        dominance=tt.SimpleDominanceChecker(tk.KPDominance(), pb.nb_variables), **extra))
    assert plane[0] == tk.dp_optimum(pb.capacity, pb.profit, pb.weight) and plane[4] > 1


@pytest.mark.parametrize("cutset", ["LAST_EXACT_LAYER", "FRONTIER"])
def test_compact_equivalence_misp(cutset):
    """Long arcs and a dynamic order through the compact route."""
    _, bundle, _ = misp_pair(24, seed=4, p=0.2)
    plane = _assert_equiv(lambda: tt.SequentialSolver(
        bundle, width_heu=tt.FixedWidth(2), batch=4, cache=tt.SimpleCache(),
        cutset_type=tt.CutsetType[cutset], device="cpu"))
    assert plane[4] > 1


def test_cutset_overflow_falls_back(monkeypatch):
    """A tiny cutset cap must not lose cutset rows: with the cap at 2 the
    count exceeds it and the solver proves the same optimum through the
    plane-route fallback."""
    _, bundle, _ = mcp_pair(12, seed=1)

    def make():
        return tt.SequentialSolver(bundle, width_heu=tt.FixedWidth(3), batch=4,
                                   cache=tt.SimpleCache(), cutset_type=tt.FRONTIER,
                                   device="cpu")

    expect = _solve(make, True)
    orig = EX.extract_caps
    fell_back = []
    orig_enqueue = tt.SequentialSolver._enqueue_cutset
    monkeypatch.setattr(EX, "extract_caps",
                        lambda K, n1, W: (orig(K, n1, W)[0], orig(K, n1, W)[1], 2))
    monkeypatch.setattr(tt.SequentialSolver, "_enqueue_cutset",
                        lambda self, nd, dd: (fell_back.append(1),
                                              orig_enqueue(self, nd, dd))[1])
    got = _solve(make, True)
    assert got[:2] == expect[:2] and got[1] and fell_back
