"""Models whose sorts need more than 128 operands: max2sat and max-cut
past 122 variables (n + 6 sort operands per layer), which a compiler for
the card once refused.  `_check_sort_operands` takes them up to K1's cap
(`ops/sort.py:MAX_OPERANDS`), and at n=135 (the frb15-9 instances' size,
141 operands) every plane of the port's restricted and relaxed compiles
equals ddo_tpu's, bit for bit, for lanes rooted at different depths.
One seeded instance crosses into both packages as numpy tables.
Tolerance: exact, every value is an integer or a bool."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.engine.mdd import DDCompiler as JCompiler
from ddo_tpu.models import max2sat as jms, mcp as jmc
from ddo_tpu_torch.core import problem as tp
from ddo_tpu_torch.core.types import root_subproblem as t_root
from ddo_tpu_torch.engine.mdd import DDCompiler, _check_sort_operands, sort_operands
from ddo_tpu_torch.models import max2sat as tms, mcp as tmc
from ddo_tpu_torch.ops import sort as srt
from ddo_tpu_torch.utils.num import NEG_INF

from test_torch_misp import _as_jsub, assert_batches_equal

W = 8


def max2sat_bundles(n, seed=0):
    """`generate_random(n, 3n, seed)`'s clauses in both packages."""
    _, clauses = tms.generate_random(n, 3 * n, seed)
    jp = jms.Max2Sat(n, clauses)
    pb = tms.Max2Sat.from_numpy({k: np.asarray(v) for k, v in jp.data.items()})
    return (ddo_tpu.ModelBundle(jp, jms.Max2SatRelax(jp), jms.Max2SatRanking()),
            tp.ModelBundle(pb, tms.Max2SatRelax(pb), tms.Max2SatRanking()))


def mcp_bundles(n, seed=0):
    """`generate_random(n, 0.5, seed)`'s weights in both packages."""
    pb, _ = tmc.generate_random(n, 0.5, seed)
    jp = jmc.Mcp(n, [(a, b, int(pb.w[a, b])) for a in range(n) for b in range(a + 1, n)
                     if pb.w[a, b]])
    return (ddo_tpu.ModelBundle(jp, jmc.McpRelax(jp), jmc.McpRanking()),
            tp.ModelBundle(tmc.Mcp.from_numpy(jp.w), tmc.McpRelax(pb), tmc.McpRanking()))


@pytest.mark.parametrize("n", [135, 220])
@pytest.mark.parametrize("model", ["max2sat", "mcp"])
def test_check_sort_operands_accepts_past_128(model, n):
    """n + 3 sort-1 keys and n + 6 operands: 141 at n=135, 226 at n=220,
    within MAX_OPERANDS; a compiler for the card is accepted at the
    solver's widths, and each sort has a K1 route."""
    if model == "max2sat":
        pb, _ = tms.generate_random(n, 3 * n, 0)
        bundle = tp.ModelBundle(pb, tms.Max2SatRelax(pb), tms.Max2SatRanking())
    else:
        pb, _ = tmc.generate_random(n, 0.5, 0)
        bundle = tp.ModelBundle(pb, tmc.McpRelax(pb), tmc.McpRanking())
    nk1, n_ops, nk2 = sort_operands(bundle, None)
    assert (nk1, n_ops, nk2) == (n + 3, n + 6, 4)
    assert srt.SMALL_OPERANDS < n_ops <= srt.MAX_OPERANDS
    for width in (8, 16, 256):
        _check_sort_operands(bundle, None, width)
        C = width * pb.domain_size
        assert srt.lane_sort_route(nk1, C) in ("perm", "merge")


@pytest.mark.parametrize("cutset", ["LAST_EXACT_LAYER", "FRONTIER"])
def test_max2sat_135_planes_match(cutset):
    """`max2sat.generate_random(135, 405, seed=0)` (141 sort operands), a
    fused superstep of four lanes, the root and three nodes of its
    relaxed frontier cutset at different depths, at width 8: every plane equals
    ddo_tpu's."""
    jb, tb = max2sat_bundles(135)
    assert sort_operands(tb, None)[1] == 141
    cs_j, cs_t = ddo_tpu.CutsetType[cutset], tt.CutsetType[cutset]
    tc = DDCompiler(tb, W, cs_t, device="cpu")
    root = t_root(tb.problem)
    frontier = DDCompiler(tb, W, tt.CutsetType.FRONTIER, device="cpu")
    cut = sorted(frontier.compile(tt.CompilationType.RELAXED, root, NEG_INF, 4)
                 .drain_cutset(), key=lambda s: -s.depth)
    deep = list({s.depth: s for s in cut}.values())[:3]
    assert len({s.depth for s in deep}) == 3, "fixture: lanes at different depths"
    tsubs = [root] + deep
    jc = JCompiler(jb, W, cs_j)
    jr, jx = jc.compile_fused([_as_jsub(s) for s in tsubs], NEG_INF, [2, 3, W, 4])
    tr, tx = tc.compile_fused(tsubs, NEG_INF, [2, 3, W, 4])
    depths = [s.depth for s in tsubs]
    assert_batches_equal(jr, tr, depths)
    assert_batches_equal(jx, tx, depths)
