"""Solver and API parity for the port (ddo_tpu_torch/search/solver.py,
ddo_tpu_torch/api.py): the knapsack differential matrix against the
brute-force oracle, explored/expanded counts equal to ddo_tpu's
`SequentialSolver` on the plane route, and the `maximize` knob matrix on
a generated instance against the numpy DP."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import knapsack as jk
from ddo_tpu_torch.models import knapsack as tk

from test_differential import _knapsack_oracle, _random_knapsack


def _port_bundle(jp):
    pb = tk.Knapsack.from_numpy(jp.capacity, jp.profit, jp.weight)
    return pb, tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())


@pytest.mark.parametrize("seed", range(25))
def test_knapsack_differential(seed):
    """test_differential.py's matrix: root bounds bracket the optimum at
    any width, and every cutset x filtering solver proves it."""
    rng = np.random.default_rng(seed)
    jp, profit, weight, capacity = _random_knapsack(rng)
    opt = _knapsack_oracle(profit, weight, capacity)
    pb, bundle = _port_bundle(jp)
    width = int(rng.integers(1, 4))
    compiler = tt.DDCompiler(bundle, 8, tt.FRONTIER, device="cpu")
    root = tt.root_subproblem(pb)
    assert compiler.compile(tt.CompilationType.RELAXED, root, tt.NEG_INF,
                            width).best_value() >= opt
    restricted = compiler.compile(tt.CompilationType.RESTRICTED, root, tt.NEG_INF,
                                  width).best_value()
    assert restricted is None or restricted <= opt
    for cutset, filtering in [(tt.FRONTIER, True), (tt.FRONTIER, False),
                              (tt.LAST_EXACT_LAYER, True), (tt.LAST_EXACT_LAYER, False)]:
        s = tt.SequentialSolver(
            bundle, width_heu=tt.FixedWidth(width), batch=2, buffer_width=8,
            cache=tt.SimpleCache(), cutset_type=cutset,
            dominance=tt.SimpleDominanceChecker(tk.KPDominance(), pb.nb_variables),
            in_compile_filtering=filtering, device="cpu",
        )
        assert s.maximize().is_exact, (seed, cutset)
        got = s.best_value() if s.best_value() is not None else 0
        assert got == opt, (seed, cutset, got, opt)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("cutset", ["LAST_EXACT_LAYER", "FRONTIER"])
def test_counts_match_ddo_tpu(batch, cutset):
    """The same search trajectory as ddo_tpu's plane-route solver: equal
    explored and expanded counts, bounds and supersteps."""
    rng = np.random.default_rng(17)
    jp = jk.Knapsack(60, rng.integers(1, 50, 14), rng.integers(1, 20, 14))
    pb, bundle = _port_bundle(jp)
    js = ddo_tpu.SequentialSolver(
        ddo_tpu.ModelBundle(jp, jk.KPRelax(jp), jk.KPRanking()),
        width_heu=ddo_tpu.FixedWidth(3), batch=batch, buffer_width=8,
        cache=ddo_tpu.SimpleCache(), cutset_type=ddo_tpu.CutsetType[cutset],
        dominance=ddo_tpu.SimpleDominanceChecker(jk.KPDominance(), jp.nb_variables),
    )
    ts = tt.SequentialSolver(
        bundle, width_heu=tt.FixedWidth(3), batch=batch, buffer_width=8,
        cache=tt.SimpleCache(), cutset_type=tt.CutsetType[cutset],
        dominance=tt.SimpleDominanceChecker(tk.KPDominance(), pb.nb_variables),
        device="cpu",
    )
    assert js.maximize().is_exact and ts.maximize().is_exact
    assert js._compact is False  # ddo_tpu on the CPU takes the plane route
    assert ts.best_value() == js.best_value()
    assert ts.best_upper_bound() == js.best_upper_bound()
    assert ts.explored_count == js.explored_count
    assert ts.expanded_nodes == js.expanded_nodes
    assert ts.stats.supersteps == js.stats.supersteps


@pytest.mark.parametrize("lel", [True, False])
@pytest.mark.parametrize("use_cache", [True, False])
def test_maximize_knob_matrix(lel, use_cache):
    """test_api.py's knob matrix on a generated instance."""
    pb = tk.generate_uncorrelated(30, 100, 1, 4, seed=5)
    opt = tk.dp_optimum(pb.capacity, pb.profit, pb.weight)
    sol = tt.maximize(pb, tk.KPRelax(pb), tk.KPRanking(), lel=lel,
                      use_cache=use_cache, dedup=not use_cache, width=3, device="cpu")
    assert not sol.aborted and sol.objective == opt, (lel, use_cache)
    assert sol.gap == 0.0 and sol.lower_bound == sol.upper_bound == opt
    w = sum(int(pb.weight[i]) for i, v in enumerate(sol.assignment) if v)
    p = sum(int(pb.profit[i]) for i, v in enumerate(sol.assignment) if v)
    assert w <= pb.capacity and p == opt


def test_maximize_defaults_with_dominance():
    pb = tk.generate_uncorrelated(60, 1000, 1, 100, seed=2)
    sol = tt.maximize(pb, tk.KPRelax(pb), tk.KPRanking(), batch=4,
                      dominance=tt.SimpleDominanceChecker(tk.KPDominance(),
                                                          pb.nb_variables),
                      device="cpu")
    assert not sol.aborted and sol.gap == 0.0
    assert sol.objective == tk.dp_optimum(pb.capacity, pb.profit, pb.weight)


def test_maximize_timeout_zero_aborts():
    pb = tk.generate_uncorrelated(30, 100, 1, 4, seed=5)
    sol = tt.maximize(pb, tk.KPRelax(pb), tk.KPRanking(), timeout=0.0, device="cpu")
    assert sol.aborted
    assert sol.gap == 1.0


def test_device_is_never_implicit():
    """Every entry point runs on the card unless the caller asks for the
    CPU: none falls back to the CPU's plain versions on its own, and
    without a card each one raises."""
    pb = tk.generate_uncorrelated(10, 100, 1, 4, seed=3)
    bundle = tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())
    makers = [lambda: tt.SequentialSolver(bundle).compiler,
              lambda: tt.DefaultSolver(bundle).compiler,
              lambda: tt.DDCompiler(bundle, 8)]
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    assert tt.DDCompiler(bundle, 8, device="cpu").device.type == "cpu"


def test_maximize_defaults_to_card():
    """`maximize` without `device` solves on the card, and raises where
    there is none."""
    pb = tk.generate_uncorrelated(12, 100, 1, 4, seed=4)
    if torch.cuda.is_available():
        sol = tt.maximize(pb, tk.KPRelax(pb), tk.KPRanking())
        assert sol.objective == tk.dp_optimum(pb.capacity, pb.profit, pb.weight)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.maximize(pb, tk.KPRelax(pb), tk.KPRanking())


def test_time_budget_engages_chunked_compiles():
    """A generous TimeBudget takes the two-pass chunked route and proves
    the same optimum as the fused route."""
    pb = tk.generate_uncorrelated(40, 100, 1, 4, seed=8)
    bundle = tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())
    s = tt.SequentialSolver(bundle, width_heu=tt.FixedWidth(3), batch=4,
                            cache=tt.SimpleCache(), cutoff=tt.TimeBudget(3600),
                            compile_chunk=8, device="cpu")
    assert s.compile_chunk == 8 and s.maximize().is_exact
    assert s.best_value() == tk.dp_optimum(pb.capacity, pb.profit, pb.weight)


def test_solver_aliases():
    pb = tk.generate_uncorrelated(20, 100, 1, 4, seed=9)
    bundle = tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())
    opt = tk.dp_optimum(pb.capacity, pb.profit, pb.weight)
    for make in (tt.DefaultSolver, tt.DefaultCachingSolver, tt.SeqCachingSolverLel,
                 tt.SeqNoCachingSolverFc):
        s = make(bundle, width_heu=tt.FixedWidth(4), device="cpu")
        assert s.maximize().is_exact and s.best_value() == opt
