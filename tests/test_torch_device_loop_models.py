"""DeviceLoopSolver parity on the engine's other paths: MISP (a dynamic
variable order per lane and long arcs), golomb (`NbUnassignedWidth`
evaluated on the device) and LCS (long arcs, the dominance buffer).  The
port's `DeviceLoopSolver(device="cpu")` against ddo_tpu's on one
generated instance each: equal best value, bounds, solution, explored
and expanded counts, supersteps and `loop_events`.  Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import lcs as jlc
from ddo_tpu_torch.models import lcs as tlc

from test_torch_device_loop import assert_same_run, run_pair
from test_torch_lcs import lcs_pair
from test_torch_models import golomb_pair, misp_pair


def both(make, **kw):
    """`make(pkg)`'s solver settings for ddo_tpu and for the port on the CPU."""
    return make(ddo_tpu) | kw, make(tt) | kw | dict(device="cpu")


def test_misp_dynamic_order_counts():
    jb, tb, inst = misp_pair(18, 0, 0.3)
    jkw, tkw = both(lambda pkg: dict(width_heu=pkg.FixedWidth(2),
                                     cutset_type=pkg.LAST_EXACT_LAYER),
                    batch=4, slab_cap=256, chunk_steps=6, cut_cap=64)
    js, jc, ts, tc = run_pair(jb, tb, jkw, tkw)
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.stats.supersteps > 1 and ts.loop_events["chunks"] > 1
    vals, pset = ts.best_solution()
    chosen = [i for i in range(18) if pset[i] and vals[i] == 1]
    edges = {frozenset(e) for e in inst["edges"]}
    assert not any(frozenset((a, b)) in edges for a in chosen for b in chosen if a < b)
    assert sum(int(inst["weight"][i]) for i in chosen) == ts.best_value()


def test_golomb_nbunassigned_width_counts():
    jb, tb, _ = golomb_pair(5)
    n = tb.problem.nb_variables
    jkw, tkw = both(lambda pkg: dict(width_heu=pkg.NbUnassignedWidth(n),
                                     cache=pkg.SimpleCache(), cutset_type=pkg.FRONTIER),
                    batch=4, slab_cap=256, chunk_steps=8, cut_cap=64)
    js, jc, ts, tc = run_pair(jb, tb, jkw, tkw)
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.best_value() == -11 and ts.stats.supersteps > 1


def test_lcs_long_arcs_and_dominance_counts():
    rng = np.random.default_rng(1)
    jb, tb = lcs_pair([list(rng.integers(0, 3, k)) for k in (14, 12, 13)], 3)
    jkw, tkw = both(lambda pkg: dict(width_heu=pkg.FixedWidth(2), cache=pkg.SimpleCache(),
                                     cutset_type=pkg.LAST_EXACT_LAYER),
                    batch=4, slab_cap=64, chunk_steps=4, cut_cap=32)
    n = tb.problem.nb_variables
    jkw["dominance"] = ddo_tpu.SimpleDominanceChecker(jlc.LcsDominance(), n)
    tkw["dominance"] = tt.SimpleDominanceChecker(tlc.LcsDominance(), n)
    js, jc, ts, tc = run_pair(jb, tb, jkw, tkw)
    assert_same_run(js, jc, ts, tc)
    assert tc.is_exact and ts.stats.supersteps > 1
