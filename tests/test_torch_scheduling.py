"""Parity of the scheduling models of ddo_tpu_torch (psp, alp) against
ddo_tpu: every hook under `jax.vmap` on random reachable states, and the
solver's proved optimum against brute force on the seeds of
tests/test_{psp,alp}.py, with ddo_tpu's explored and expanded counts at
batch 1.  Helpers and conventions: test_torch_tsptw.py and
test_torch_sequencing.py.  Tolerance: exact, every value is an integer or
a bool.

ALP is the one documented divergence: where the separations break the
triangle inequality the port bounds with 0 (ddo_tpu keeps its queueing
bound), so its parity tests use instances that pass the check, and a test
of its own holds the fallback."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import alp as jal, psp as jps
from ddo_tpu_torch.core import problem as tp
from ddo_tpu_torch.models import alp as tal, psp as tps

from test_alp import brute_force as alp_brute_force
from test_psp import brute_force as psp_brute_force
from test_torch_sequencing import _counts, _prove
from test_torch_tsptw import check_hooks, rollout


def psp_arrays(seed):
    """tests/test_psp.py:72's instance for `seed`, and its width."""
    rng = np.random.default_rng(900 + seed)
    H = int(rng.integers(4, 9))
    N = int(rng.integers(2, 4))
    demands = (rng.random((N, H)) < 0.35).astype(np.int64)
    for t in range(H):
        while demands[:, : t + 1].sum() > t + 1:
            nz = np.argwhere(demands[:, : t + 1])
            i, tt_ = nz[rng.integers(len(nz))]
            demands[i, tt_] = 0
    stocking = rng.integers(1, 10, N)
    changeover = rng.integers(0, 15, (N, N))
    np.fill_diagonal(changeover, 0)
    return (H, stocking, changeover, demands), int(rng.integers(2, 6))


def psp_pair(args):
    jp = jps.Psp(*args)
    pb = tps.Psp.from_numpy(jp.horizon, jp.stocking, jp.changeover, jp.demands)
    return (ddo_tpu.ModelBundle(jp, jps.PspRelax(jp), jps.PspRanking()),
            tp.ModelBundle(pb, tps.PspRelax(pb), tps.PspRanking()))


def psp_pair(args):
    jp = jps.Psp(*args)
    pb = tps.Psp.from_numpy(jp.horizon, jp.stocking, jp.changeover, jp.demands)
    return (ddo_tpu.ModelBundle(jp, jps.PspRelax(jp), jps.PspRanking()),
            tp.ModelBundle(pb, tps.PspRelax(pb), tps.PspRanking()))


def alp_arrays(seed):
    """tests/test_alp.py:54's instance for `seed`, and its width."""
    rng = np.random.default_rng(800 + seed)
    n = int(rng.integers(4, 8))
    C = int(rng.integers(1, 3))
    R = int(rng.integers(1, 3))
    target = np.sort(rng.integers(0, 60, n))
    latest = target + rng.integers(30, 200, n)
    classes = rng.integers(0, C, n)
    sep = rng.integers(3, 15, (C, C))
    return (C, R, target, latest, classes, sep), int(rng.integers(2, 8))


def alp_pair(args):
    jp = jal.Alp(*args)
    pb = tal.Alp.from_numpy(jp.nb_classes, jp.nb_runways, jp.target, jp.latest,
                            jp.classes, jp.sep)
    return (ddo_tpu.ModelBundle(jp, jal.AlpRelax(jp), jal.AlpRanking()),
            tp.ModelBundle(pb, tal.AlpRelax(pb), tal.AlpRanking()))


def alp_pair(args):
    jp = jal.Alp(*args)
    pb = tal.Alp.from_numpy(jp.nb_classes, jp.nb_runways, jp.target, jp.latest,
                            jp.classes, jp.sep)
    return (ddo_tpu.ModelBundle(jp, jal.AlpRelax(jp), jal.AlpRanking()),
            tp.ModelBundle(pb, tal.AlpRelax(pb), tal.AlpRanking()))


def test_psp_hooks_match():
    jb, tb = psp_pair(psp_arrays(1)[0])
    check_hooks(jb, tb, (), rollout(tb))


def test_alp_hooks_match():
    """Two classes and two runways, separations that pass the check."""
    jb, tb = alp_pair((2, 2, [3, 9, 10, 20, 24, 31, 40], [80, 90, 120, 95, 200, 150, 160],
                       [0, 1, 1, 0, 1, 0, 0], [[4, 6], [5, 3]]))
    assert tb.problem.queueing_rub
    check_hooks(jb, tb, (), rollout(tb), jal.AlpDominance(), tal.AlpDominance())


@pytest.mark.parametrize("seed", range(4))
def test_psp_random_vs_bruteforce(seed):
    args, width = psp_arrays(seed)
    _, tb = psp_pair(args)
    best = psp_brute_force(tb.problem)
    _prove(tb, None if best is None else -best, width_heu=tt.FixedWidth(width),
           buffer_width=8)


@pytest.mark.parametrize("seed", range(5))
def test_alp_random_vs_bruteforce(seed):
    """Every seed of tests/test_alp.py, whichever rough bound the
    separations allow."""
    args, width = alp_arrays(seed)
    _, tb = alp_pair(args)
    n = tb.problem.nb_variables
    best = alp_brute_force(tb.problem)
    _prove(tb, None if best is None else -best, False, width_heu=tt.FixedWidth(width),
           cutset_type=tt.FRONTIER, buffer_width=8,
           dominance=tt.SimpleDominanceChecker(tal.AlpDominance(), n))


def _admissible_alp_seed():
    """The first seed of tests/test_alp.py whose separations pass the
    check (so ddo_tpu's bound is the port's)."""
    for seed in range(5):
        args, _ = alp_arrays(seed)
        if tal.separation_admissible(args[5]):
            return seed
    raise AssertionError("no seed passes the check")


@pytest.mark.parametrize("name", ["psp", "alp"])
def test_counts_match_ddo_tpu_at_batch_1(name):
    """The same search as ddo_tpu's at batch 1 on one seed of each model's
    test file: optimum, bounds, explored, expanded, supersteps, solution."""
    if name == "psp":
        args, width = psp_arrays(1)
        _counts(*psp_pair(args), width, cutset="LAST_EXACT_LAYER")
    else:
        args, width = alp_arrays(_admissible_alp_seed())
        _counts(*alp_pair(args), width, (jal.AlpDominance, tal.AlpDominance))


def test_alp_rub_falls_back_where_separation_breaks_triangle():
    """Separations that break the triangle inequality (0 -> 1 -> 0 cheaper
    than 0 -> 0) turn the queueing bound off: the port's rough bound is 0
    on every state, ddo_tpu's is not, and the port still proves the brute
    force optimum."""
    sep = [[20, 3], [3, 9]]
    assert not tal.separation_admissible(sep) and not tal.separation_admissible([[-1]])
    assert tal.separation_admissible([[4, 6], [5, 3]])
    args = (2, 1, [0, 2, 4, 30, 35, 50], [150, 160, 180, 190, 200, 260],
            [0, 0, 1, 0, 0, 1], sep)
    jb, tb = alp_pair(args)
    assert not tb.problem.queueing_rub
    layers = rollout(tb)
    rdata = tb.relaxation.data("cpu")
    jrub = []
    for depth, st, _ in layers:
        assert not tb.relaxation.rub(rdata, st, depth).any()
        js = {k: np.asarray(v.numpy()) for k, v in st.items()}
        jrub.append(np.asarray(jb.relaxation.rub(jb.relaxation.data,
                                                 {k: v[0] for k, v in js.items()}, depth)))
    assert any(r != 0 for r in jrub)  # ddo_tpu's queueing bound is on
    best = alp_brute_force(tb.problem)
    _prove(tb, -best, False, width_heu=tt.FixedWidth(3), cutset_type=tt.FRONTIER,
           buffer_width=8,
           dominance=tt.SimpleDominanceChecker(tal.AlpDominance(), tb.problem.nb_variables))


def test_generators():
    """The seeded generators give feasible instances: PSP's demand due by
    every period fits the periods elapsed; ALP's separations pass the
    check."""
    p = tps.generate_random(8, 3, seed=2)
    assert (np.cumsum(p.demands.sum(0)) <= np.arange(1, 9)).all()
    assert np.array_equal(p.demands, tps.generate_random(8, 3, seed=2).demands)
    a = tal.generate_random(7, 2, 2, seed=4)
    assert a.queueing_rub and a.nb_variables == 7
