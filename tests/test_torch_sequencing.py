"""Parity of the sequencing models of ddo_tpu_torch (sop, srflp) against
ddo_tpu: every hook under `jax.vmap` on random reachable states, every
plane of srflp's restricted and relaxed compiles, and the solver's proved
optimum against brute force on the seeds of tests/test_{sop,srflp}.py,
with ddo_tpu's explored and expanded counts at batch 1 (psp and alp:
test_torch_scheduling.py, which shares `_prove` and `_counts`).  Helpers
and conventions: test_torch_tsptw.py.  Tolerance: exact; srflp's float32
cut/length ratio is computed as ddo_tpu computes it, so its rough bound
is equal too."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import sop as jso, srflp as jsr
from ddo_tpu_torch.core import problem as tp
from ddo_tpu_torch.engine.mdd import _check_sort_operands
from ddo_tpu_torch.models import sop as tso, srflp as tsr

from test_sop import brute_force as sop_brute_force
from test_srflp import brute_force as srflp_brute_force
from test_torch_tsptw import check_compiles, check_counts, check_hooks, rollout

SET_BITS = {"prev", "must", "maybe"}


# ------------------------------------------------------- one instance, twice
def sop_arrays(seed):
    """tests/test_sop.py:53's instance for `seed`, and its width."""
    rng = np.random.default_rng(600 + seed)
    n = int(rng.integers(4, 8))
    dist = rng.integers(1, 50, (n, n)).astype(np.int64)
    np.fill_diagonal(dist, 0)
    dist[:, 0] = -1
    dist[n - 1, :n - 1] = -1
    dist[0, 0] = 0
    if n > 4:
        dist[2][1] = -1
    return dist, int(rng.integers(2, 8))


def sop_pair(dist):
    jp = jso.Sop(dist)
    pb = tso.Sop.from_numpy(jp.dist)
    return (ddo_tpu.ModelBundle(jp, jso.SopRelax(jp), jso.SopRanking()),
            tp.ModelBundle(pb, tso.SopRelax(pb), tso.SopRanking()))


def srflp_arrays(seed):
    """tests/test_srflp.py:54's instance for `seed`, and its width."""
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(4, 7))
    lengths = rng.integers(1, 10, n)
    flows = rng.integers(0, 8, (n, n))
    flows = flows + flows.T
    np.fill_diagonal(flows, 0)
    return lengths, flows, int(rng.integers(2, 8))


def srflp_pair(lengths, flows):
    jp = jsr.Srflp(lengths, flows)
    pb = tsr.Srflp.from_numpy(jp.lengths, jp.flows)
    return (ddo_tpu.ModelBundle(jp, jsr.SrflpRelax(jp), jsr.SrflpRanking()),
            tp.ModelBundle(pb, tsr.SrflpRelax(pb), tsr.SrflpRanking()))


# the instances the hook parity walks: one of each, a little larger
HOOK_PAIRS = {
    "sop": lambda: sop_pair(tso.generate_random(8, 1, p_prec=0.2).dist),
    "srflp": lambda: srflp_pair(*srflp_arrays(3)[:2]),
}


@pytest.mark.parametrize("name", sorted(HOOK_PAIRS))
def test_hooks_match(name):
    jb, tb = HOOK_PAIRS[name]()
    check_hooks(jb, tb, SET_BITS, rollout(tb))


def test_srflp_planes_match():
    """srflp's restricted and relaxed compiles (its cut vector rides the
    sort as 6 of 8 state words), batch 1 and 4, every plane."""
    jb, tb = srflp_pair(*srflp_arrays(3)[:2])
    check_compiles(jb, tb, SET_BITS, 8, [2, 3, 8, 4])


# ----------------------------------------------------- solver vs brute force
def _prove(tb, expected, same_counts=True, **kw):
    """The port's solver on the CPU proves `expected` by both extraction
    routes, with one trajectory unless a dominance store is on (where the
    two routes may explore differently, ROADMAP C.2)."""
    runs = []
    for compact in (False, True):
        s = tt.SequentialSolver(tb, cache=tt.SimpleCache(), device="cpu", **kw)
        s._compact = compact
        assert s.maximize().is_exact
        assert s.best_value() == expected, (compact, s.best_value(), expected)
        runs.append((s.explored_count, s.expanded_nodes, s.stats.supersteps))
    assert runs[0] == runs[1] or not same_counts
    return s


@pytest.mark.parametrize("seed", range(5))
def test_sop_random_vs_bruteforce(seed):
    dist, width = sop_arrays(seed)
    _, tb = sop_pair(dist)
    best = sop_brute_force(dist.tolist())
    _prove(tb, None if best is None else -best, width_heu=tt.FixedWidth(width),
           cutset_type=tt.FRONTIER, buffer_width=8)


@pytest.mark.parametrize("seed", range(4))
def test_srflp_random_vs_bruteforce(seed):
    lengths, flows, width = srflp_arrays(seed)
    _, tb = srflp_pair(lengths, flows)
    s = tt.SequentialSolver(tb, width_heu=tt.FixedWidth(width), cache=tt.SimpleCache(),
                            cutset_type=tt.FRONTIER, buffer_width=8, device="cpu")
    assert s.maximize().is_exact
    got = -s.best_value() + tb.problem.root_value
    assert abs(got - srflp_brute_force(lengths.tolist(), flows.tolist())) < 1e-6


def _counts(jb, tb, width, dominance=None, **kw):
    """ddo_tpu's and the port's solvers at batch 1 (`check_counts`), with
    the dominance classes `dominance` (ddo_tpu's, the port's) if given."""
    n = jb.problem.nb_variables
    jdom = tdom = None
    if dominance is not None:
        jdom = ddo_tpu.SimpleDominanceChecker(dominance[0](), n)
        tdom = tt.SimpleDominanceChecker(dominance[1](), n)
    js = ddo_tpu.SequentialSolver(jb, width_heu=ddo_tpu.FixedWidth(width), batch=1,
                                  buffer_width=8, cache=ddo_tpu.SimpleCache(),
                                  dominance=jdom,
                                  cutset_type=ddo_tpu.CutsetType[kw.get("cutset", "FRONTIER")])
    ts = tt.SequentialSolver(tb, width_heu=tt.FixedWidth(width), batch=1, buffer_width=8,
                             cache=tt.SimpleCache(), dominance=tdom, device="cpu",
                             cutset_type=tt.CutsetType[kw.get("cutset", "FRONTIER")])
    check_counts(js, ts)


@pytest.mark.parametrize("name", ["sop", "srflp"])
def test_counts_match_ddo_tpu_at_batch_1(name):
    """The same search as ddo_tpu's at batch 1 on one seed of each model's
    test file: optimum, bounds, explored, expanded, supersteps, solution."""
    if name == "sop":
        dist, width = sop_arrays(1)
        _counts(*sop_pair(dist), width)
    else:
        lengths, flows, width = srflp_arrays(1)
        _counts(*srflp_pair(lengths, flows), width)


def test_generators_and_full_width_sort_operands():
    """The seeded generators give one instance per seed; srflp at n = 60
    (5 + 64 + 1 = 70 sort operands, over K1's earlier 64) and sop at 380
    jobs, both at width 256, are accepted by a compiler built for a card:
    their sorts take K1's "merge" route."""
    from ddo_tpu_torch.ops import sort as srt

    assert np.array_equal(tso.generate_random(9, 3).dist, tso.generate_random(9, 3).dist)
    assert np.array_equal(tsr.generate_random(9, 3).flows, tsr.generate_random(9, 3).flows)
    pb = tsr.generate_random(60, 0)
    _check_sort_operands(tp.ModelBundle(pb, tsr.SrflpRelax(pb), tsr.SrflpRanking()), None, 256)
    assert srt.lane_sort_route(3 + 64, 256 * 60) == "merge"
    pb = tso.generate_random(380, 0)
    _check_sort_operands(tp.ModelBundle(pb, tso.SopRelax(pb), tso.SopRanking()), None, 256)
    assert srt.lane_sort_route(3 + 36, 256 * 380) == "merge"
