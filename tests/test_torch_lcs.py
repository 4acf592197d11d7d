"""LCS parity (ddo_tpu_torch/models/lcs.py) against ddo_tpu: every hook
under `jax.vmap` (the long-arc predicate and the dominance columns
included) on random reachable states, every plane of a restricted and a
relaxed compile in long-arc mode at batch 1 and 4, and the solver's
proved optimum against the multi-string DP on the seeds of
tests/test_lcs.py, with ddo_tpu's explored and expanded counts at batch 1.
The port gathers its int32 tables where ddo_tpu contracts float32 one-hot
rows on the TPU's matrix unit.  Helpers and conventions:
test_torch_tsptw.py.  Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import lcs as jlc
from ddo_tpu_torch.core import problem as tp
from ddo_tpu_torch.engine.mdd import _check_sort_operands
from ddo_tpu_torch.models import lcs as tlc

from test_lcs import brute_lcs
from test_torch_tsptw import check_compiles, check_counts, check_hooks, rollout


def lcs_strings(seed):
    """tests/test_lcs.py:53's instance for `seed`, and its width."""
    rng = np.random.default_rng(400 + seed)
    m = int(rng.integers(2, 4))
    n_chars = int(rng.integers(2, 5))
    strings = [[int(x) for x in rng.integers(0, n_chars, int(rng.integers(5, 14)))]
               for _ in range(m)]
    return strings, n_chars, int(rng.integers(2, 8))


def lcs_pair(strings, n_chars):
    jp = jlc.Lcs(strings, n_chars)
    pb = tlc.Lcs.from_numpy(jp.strings, jp.n_chars)
    return (ddo_tpu.ModelBundle(jp, jlc.LcsRelax(jp), jlc.LcsRanking()),
            tp.ModelBundle(pb, tlc.LcsRelax(pb), tlc.LcsRanking()))


def fixture_pair():
    """Three strings over four letters, 9 to 11 characters."""
    rng = np.random.default_rng(11)
    return lcs_pair([list(rng.integers(0, 4, k)) for k in (9, 11, 10)], 4)


def test_lcs_tables_are_ddo_tpus():
    """`next`, `rem` and the pair tables equal ddo_tpu's float32 tables."""
    jb, tb = fixture_pair()
    data = tb.problem.data("cpu")
    for name in ("next", "rem", "tables", "lengths"):
        np.testing.assert_array_equal(np.asarray(jb.problem.data[name]).astype(np.int64),
                                      data[name].numpy(), err_msg=name)
    assert data["next"].dtype == torch.int32


def test_lcs_hooks_match():
    jb, tb = fixture_pair()
    check_hooks(jb, tb, (), rollout(tb), jlc.LcsDominance(), tlc.LcsDominance())


def test_lcs_planes_match():
    """Long arcs (`bs`) with the dominance filter in the layer."""
    jb, tb = fixture_pair()
    check_compiles(jb, tb, (), 8, [2, 3, 8, 4], jlc.LcsDominance(), tlc.LcsDominance())


def _solver(pkg, bundle, n, width, dom):
    return pkg.SequentialSolver(
        bundle, width_heu=pkg.FixedWidth(width), cache=pkg.SimpleCache(),
        dominance=pkg.SimpleDominanceChecker(dom, n), cutset_type=pkg.FRONTIER,
        **({"device": "cpu"} if pkg is tt else {}))


@pytest.mark.parametrize("seed", range(5))
def test_lcs_random_vs_bruteforce(seed):
    strings, n_chars, width = lcs_strings(seed)
    _, tb = lcs_pair(strings, n_chars)
    s = _solver(tt, tb, tb.problem.nb_variables, width, tlc.LcsDominance())
    assert s.maximize().is_exact
    assert (s.best_value() or 0) == brute_lcs(strings)


def test_lcs_counts_match_ddo_tpu():
    strings, n_chars, width = lcs_strings(1)
    jb, tb = lcs_pair(strings, n_chars)
    n = tb.problem.nb_variables
    check_counts(_solver(ddo_tpu, jb, n, width, jlc.LcsDominance()),
                 _solver(tt, tb, n, width, tlc.LcsDominance()))


def test_lcs_generator_and_full_width_sort_operands():
    """10 strings over 20 letters at width 256: lanes of 5,376 candidates
    with 13 sort-1 keys, past shared memory, on K1's "merge" route."""
    from ddo_tpu_torch.ops import sort as srt

    pb = tlc.generate_random(10, 20, 60, seed=0)
    assert pb.n_strings == 10 and pb.domain_size == 21
    assert np.array_equal(pb.strings[3], tlc.generate_random(10, 20, 60, seed=0).strings[3])
    _check_sort_operands(tp.ModelBundle(pb, tlc.LcsRelax(pb), tlc.LcsRanking()),
                         tlc.LcsDominance(), 256)
    assert srt.lane_sort_route(13, 256 * 21) == "merge"
