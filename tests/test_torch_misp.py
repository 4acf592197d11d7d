"""Engine parity for the models that need more than the knapsack path:
MISP (a dynamic variable order chosen per lane and per layer, long arcs,
bitset states), max2sat (`relax_cost`, a non-zero initial value) and
golomb (a wide domain).  Every plane of the port's restricted and relaxed
compiles (ddo_tpu_torch/engine/mdd.py) equals ddo_tpu's, bit for bit, for
one lane and for four lanes rooted at different depths.

Each lane is compared from its root depth down: above a batch's minimum
root depth ddo_tpu scans empty layers that the port leaves at their
neutral fill.  A merged node's best in-edge is compared exactly: both
engines break its ties by the largest flat candidate index, so the one
member of the tie set they pick is the same."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.core.types import SubProblem as JSub
from ddo_tpu.engine.mdd import DDCompiler as JCompiler
from ddo_tpu_torch.core.types import root_subproblem as t_root
from ddo_tpu_torch.engine.mdd import DDCompiler, has_long_arcs
from ddo_tpu_torch.utils.num import NEG_INF

from test_torch_models import BITSET_LEAVES, PAIRS

CS_J, CS_T = ddo_tpu.CutsetType, tt.CutsetType
W = 16  # golomb n=5 has D=14 slots: the first layer must fit the buffer

LAYERED = ["value", "mask", "exact", "relaxed", "keys", "rank0", "rub", "bp", "bd", "bs",
           "var_of", "value_bot", "marked", "theta", "has_theta", "above", "cutflag",
           "wl_pruned", "wl_unexplored"]
PER_LANE = ["lel", "is_exact_dd", "has_ebp", "feasible", "best_slot", "best_value",
            "bx_feasible", "bx_slot", "bx_value", "expanded", "overflow", "root_depth"]


def assert_batches_equal(jbatch, tbatch, depths):
    jget, tget = jbatch._planes.get, tbatch._planes.get
    for name in PER_LANE:
        np.testing.assert_array_equal(np.asarray(jget(name))[:len(depths)], tget(name),
                                      err_msg=name)
    jstate, tstate = jget("state"), tget("state")
    for k, d in enumerate(depths):
        for name in LAYERED:
            np.testing.assert_array_equal(np.asarray(jget(name))[k][d:], tget(name)[k][d:],
                                          err_msg=f"{name}, lane {k} from layer {d}")
        for leaf in jstate:
            j = np.ascontiguousarray(np.asarray(jstate[leaf])[k][d:])
            if leaf in BITSET_LEAVES:
                j = j.view(np.int32)
            np.testing.assert_array_equal(j, tstate[leaf][k][d:],
                                          err_msg=f"state {leaf}, lane {k}")
    assert jbatch.global_best == tbatch.global_best
    assert jbatch.total_expanded == tbatch.total_expanded


def _as_jsub(sub):
    """A port subproblem as ddo_tpu's (bitset words viewed as uint32)."""
    state = {k: (np.ascontiguousarray(v).view(np.uint32) if k in BITSET_LEAVES
                 else np.asarray(v)) for k, v in sub.state.items()}
    return JSub(state=state, value=sub.value, path_vals=sub.path_vals,
                path_set=sub.path_set, ub=sub.ub, depth=sub.depth, key=sub.key)


def _deep_lanes(tb):
    """The root and three cutset nodes of its relaxed frontier DD, at as
    many different depths as the DD has."""
    root = t_root(tb.problem)
    dd = DDCompiler(tb, W, CS_T.FRONTIER, device="cpu").compile(
        tt.CompilationType.RELAXED, root, NEG_INF, 2)
    cut = sorted(dd.drain_cutset(), key=lambda s: -s.depth)
    deep = list({s.depth: s for s in cut}.values())  # one node per depth first
    deep = (deep + [s for s in cut if all(s is not d for d in deep)])[:3]
    assert len(deep) == 3 and len({s.depth for s in deep}) >= 2, \
        "fixture: four lanes, not all at one depth"
    return [root] + deep


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("cutset", ["LAST_EXACT_LAYER", "FRONTIER"])
@pytest.mark.parametrize("name", ["misp", "max2sat", "golomb"])
def test_planes_match(name, cutset, lanes):
    """A fused superstep (restricted, then relaxed against the restricted
    incumbent) at several widths and incumbents."""
    jb, tb, _ = PAIRS[name]()
    jc = JCompiler(jb, W, CS_J[cutset])
    tc = DDCompiler(tb, W, CS_T[cutset], device="cpu")
    tsubs = [t_root(tb.problem)] if lanes == 1 else _deep_lanes(tb)
    jsubs = [_as_jsub(s) for s in tsubs]
    depths = [s.depth for s in tsubs]
    cases = [([2], NEG_INF), ([3], NEG_INF), ([W], NEG_INF)] if lanes == 1 else \
        [([2, 3, 2, 4], NEG_INF), ([3, 2, 5, 2], tsubs[1].value)]
    for widths, best_lb in cases:
        jr, jx = jc.compile_fused(jsubs, best_lb, widths)
        tr, tx = tc.compile_fused(tsubs, best_lb, widths)
        assert_batches_equal(jr, tr, depths)
        assert_batches_equal(jx, tx, depths)


def test_misp_order_is_per_lane_and_long_arcs_skip():
    """What the MISP planes must show beyond equality: lanes of one batch
    branch on different variables at one layer, `bs` marks long arcs, and
    no path records a decision on one."""
    _, tb, _ = PAIRS["misp"]()
    assert tb.problem.var_order() is None and has_long_arcs(tb.problem)
    tsubs = _deep_lanes(tb)
    batch = DDCompiler(tb, W, CS_T.FRONTIER, device="cpu").compile_batch(
        tt.CompilationType.RELAXED, tsubs, NEG_INF, [3] * len(tsubs))
    var_of, bs, mask = (batch._planes.get(k) for k in ("var_of", "bs", "mask"))
    d = max(s.depth for s in tsubs)
    assert any(len(set(var_of[:, l])) > 1 for l in range(d, var_of.shape[1]))
    assert (bs & mask).any() and not (bs & ~mask).any()
    for k, (sub, dd) in enumerate(zip(tsubs, batch)):
        # a lane branches on each variable once, never on one its root decided
        order = var_of[k][sub.depth:]
        assert len(set(order)) == len(order) and not sub.path_set[order].any()
        # its best path decides exactly the variables of its non-skip arcs
        _, pset = dd.best_solution()
        l, s, decided = dd.n, int(dd.o["best_slot"]), []
        while l > sub.depth:
            if not dd.o["bs"][l, s]:
                decided.append(int(dd.o["var_of"][l - 1]))
            s, l = int(dd.o["bp"][l, s]), l - 1
        assert sorted(np.flatnonzero(pset & ~sub.path_set)) == sorted(decided)


def test_path_walkers_agree_on_long_arcs():
    """`_path`, `_paths_batch` and `paths_batch_multi` give one answer for
    every cutset node of a MISP batch, and ddo_tpu's cutset the same."""
    from ddo_tpu_torch.engine.mdd import paths_batch_multi

    jb, tb, _ = PAIRS["misp"]()
    tsubs = _deep_lanes(tb)
    widths = [2] * len(tsubs)
    batch = DDCompiler(tb, W, CS_T.FRONTIER, device="cpu").compile_batch(
        tt.CompilationType.RELAXED, tsubs, NEG_INF, widths)
    jbatch = JCompiler(jb, W, CS_J.FRONTIER).compile_batch(
        ddo_tpu.CompilationType.RELAXED, [_as_jsub(s) for s in tsubs], NEG_INF, widths)
    assert (batch._planes.get("cutflag") & batch._planes.get("marked")).any()
    for k, (dd, jd) in enumerate(zip(batch, jbatch)):
        layers, slots = np.nonzero(dd.o["cutflag"] & dd.o["marked"])
        vals, psets = dd._paths_batch(layers, slots)
        mv, mp = paths_batch_multi(batch._planes, [k] * len(layers), layers, slots, tsubs)
        np.testing.assert_array_equal(vals, mv)
        np.testing.assert_array_equal(psets, mp)
        cut = list(dd.drain_cutset())
        jcut = list(jd.drain_cutset())
        assert len(cut) == len(jcut) == len(layers)
        for i, (sub, jsub) in enumerate(zip(cut, jcut)):
            np.testing.assert_array_equal(sub.path_vals, vals[i])
            np.testing.assert_array_equal(sub.path_set, psets[i])
            np.testing.assert_array_equal(sub.path_vals, jsub.path_vals)
            np.testing.assert_array_equal(sub.path_set, jsub.path_set)
            assert (sub.key, sub.ub, sub.depth, sub.value) == \
                (jsub.key, jsub.ub, jsub.depth, jsub.value)
            assert sub.path_set.sum() <= sub.depth  # long arcs decide nothing


def test_root_path_set_seeds_the_dynamic_order():
    """A deep root's `path_set` is the lane's starting `assigned`: with
    every state empty the fallback picks the first variable the root's
    path has not decided."""
    _, tb, _ = PAIRS["misp"]()
    n = tb.problem.nb_variables
    root = t_root(tb.problem)
    pset = np.zeros(n, bool)
    pset[[0, 1, 3]] = True
    sub = dataclasses.replace(root, state={"free": np.zeros_like(root.state["free"])},
                              path_set=pset, depth=3)
    dd = DDCompiler(tb, W, device="cpu").compile(tt.CompilationType.RESTRICTED, sub,
                                                 NEG_INF, 2)
    assert list(dd.o["var_of"][3:]) == [2] + list(range(4, n))
    vals, out = dd.best_solution()
    assert dd.best_value() == 0 and not out[[2] + list(range(4, n))].any()
