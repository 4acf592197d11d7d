"""NativeSolver parity (ddo_tpu_torch/search/solver.py, ddo_tpu_torch/native):
the port's `NativeSolver(device="cpu")` over its own build of the C++
runtime against ddo_tpu's on the same generated instances, with equal
best value, bounds, solution, explored and expanded counts and
supersteps; the warm start, the cutoff's bound recovery, dominance
against `SequentialSolver`, and a failed g++ build raising with its
output.  Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import knapsack as jk
from ddo_tpu.models.tsptw import TsptwWidth as JTsptwWidth
from ddo_tpu.search.solver import NativeSolver as JNativeSolver
from ddo_tpu_torch import native
from ddo_tpu_torch.models import knapsack as tk

from test_torch_device_loop import kp_pair
from test_torch_models import misp_pair
from test_torch_scheduling import psp_arrays, psp_pair
from test_torch_tsptw import generated_pair as tsptw_pair


def run_pair(jb, tb, make, primal=None):
    """Both packages' NativeSolver with the settings `make(pkg)`."""
    js = JNativeSolver(jb, **make(ddo_tpu))
    ts = tt.NativeSolver(tb, device="cpu", **make(tt))
    if primal is not None:
        js.set_primal(*primal)
        ts.set_primal(*primal)
    return js, js.maximize(), ts, ts.maximize()


def assert_same_run(js, jc, ts, tc):
    assert (tc.is_exact, tc.best_value) == (jc.is_exact, jc.best_value)
    assert ts.best_upper_bound() == js.best_upper_bound()
    assert ts.best_lower_bound() == js.best_lower_bound()
    assert (ts.explored(), ts.expanded_nodes, ts.stats.supersteps) == \
        (js.explored(), js.expanded_nodes, js.stats.supersteps)
    if js.best_solution() is not None:
        for a, b in zip(js.best_solution(), ts.best_solution()):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_knapsack_counts():
    """ddo_tpu's counts on seed 17's knapsack at batch 4: 261, 7
    explored, 165 expanded."""
    jb, tb = kp_pair()
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(width_heu=pkg.FixedWidth(2), batch=4))
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.best_value() == 261
    assert (ts.explored(), ts.expanded_nodes) == (7, 165)
    vals, pset = ts.best_solution()
    assert (tb.problem.weight * vals * pset).sum() <= tb.problem.capacity


def test_misp_counts():
    jb, tb, inst = misp_pair(18, 0, 0.3)
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(
        width_heu=pkg.FixedWidth(4), batch=4, cutset_type=pkg.LAST_EXACT_LAYER))
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.stats.supersteps > 1


def test_tsptw_counts():
    jb, tb = tsptw_pair(8, 1)
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(
        width_heu=(JTsptwWidth if pkg is ddo_tpu else tt.TsptwWidth)(
            tb.problem.nb_variables, 1), batch=4,
        cutset_type=pkg.FRONTIER, buffer_width=64))
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.best_value() is not None


def test_psp_counts_and_sequential_optimum():
    args, width = psp_arrays(3)
    jb, tb = psp_pair(args)
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(width_heu=pkg.FixedWidth(width),
                                                        batch=4))
    assert_same_run(js, jc, ts, tc)
    seq = tt.SequentialSolver(tb, width_heu=tt.FixedWidth(width), batch=4,
                              cache=tt.SimpleCache(), device="cpu")
    assert seq.maximize().is_exact and tc.is_exact
    assert seq.best_value() == ts.best_value()


def test_set_primal_and_stats():
    jb, tb = kp_pair()
    n = tb.problem.nb_variables
    primal = (261, (np.zeros(n, np.int32), np.zeros(n, bool)))
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(width_heu=pkg.FixedWidth(3), batch=4),
                              primal)
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.best_value() == 261
    assert ts.explored_count <= 8
    assert ts.stats.total_s > 0 and ts.stats.supersteps >= 0


def test_cutoff_abort_recovers_bound():
    jb, tb = kp_pair(8, 20, correlated=True)
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(
        width_heu=pkg.FixedWidth(3), batch=4, cutoff=pkg.TimeBudget(0.0)))
    assert not tc.is_exact and not jc.is_exact
    assert ts.best_upper_bound() == js.best_upper_bound() >= ts.best_lower_bound()
    assert ts.gap() == js.gap() == 1.0


def test_chunked_compiles_under_a_cutoff():
    """A generous TimeBudget takes the two-pass chunked route (n > 32)
    with ddo_tpu's counts."""
    jb, tb = kp_pair(2, 40, correlated=True)
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(
        width_heu=pkg.FixedWidth(3), batch=4, cutoff=pkg.TimeBudget(3600.0)))
    assert ts.compile_chunk == 32
    assert_same_run(js, jc, ts, tc)
    pb = tb.problem
    assert tc.is_exact and ts.best_value() == tk.dp_optimum(pb.capacity, pb.profit, pb.weight)


def test_dominance_matches_sequential():
    jb, tb = kp_pair(8, 20, correlated=True)
    n = tb.problem.nb_variables
    js, jc, ts, tc = run_pair(jb, tb, lambda pkg: dict(
        width_heu=pkg.FixedWidth(2), batch=4, dominance=pkg.SimpleDominanceChecker(
            (jk if pkg is ddo_tpu else tk).KPDominance(), n)))
    assert_same_run(js, jc, ts, tc)
    seq = tt.SequentialSolver(tb, width_heu=tt.FixedWidth(2), batch=4, device="cpu",
                              dominance=tt.SimpleDominanceChecker(tk.KPDominance(), n))
    assert seq.maximize().is_exact and tc.is_exact
    assert ts.best_value() == seq.best_value()


def test_runtime_structures():
    """The C++ fringe pops by (ub, value, score), merges duplicate states
    (max ub, the longer path's payload) and the cache applies the
    must-explore rule."""
    ns = native.NativeSearch(3, 2)
    keys = np.asarray([[1, 2], [3, 4], [1, 2]], np.int32)
    z = np.zeros((3, 3), np.int32)
    ns.push_batch(keys, [1, 1, 1], [5, 7, 9], [10, 20, 15], [0, 0, 0], z, z.astype(bool))
    assert len(ns) == 2
    k, d, v, u, _, _, popped = ns.pop_batch(4, 0)
    assert k.tolist() == [[3, 4], [1, 2]] and v.tolist() == [7, 9] and u.tolist() == [20, 15]
    assert popped == 2 and len(ns) == 0
    ns.cache_update_batch([2], np.asarray([[1, 2]], np.int32), [10], [1])
    got = ns.cache_must_explore_batch([2, 2, 2], np.asarray([[1, 2], [1, 2], [5, 5]], np.int32),
                                      [10, 11, 0])
    assert got.tolist() == [False, True, True]


def test_failed_build_raises_with_gxx_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build_library(str(bad))
    assert "broken.cpp" in str(e.value) and "error" in str(e.value)


def test_card_is_the_default():
    _, tb = kp_pair()
    if torch.cuda.is_available():
        assert tt.NativeSolver(tb).compiler.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.NativeSolver(tb)
