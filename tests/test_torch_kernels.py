"""Kernels K1 (lane_sort) and K2 (fused_backward) of ddo_tpu_torch
against their plain PyTorch versions on an NVIDIA GPU, bit for bit.

This file imports neither jax nor ddo_tpu, so it also runs where only the
port is installed; on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py

Without a GPU every `cuda`-marked test here skips; the unmarked ones
check the wrappers' Python side (route choice, limits, refusals) on the
CPU.  `random_case` (the random planes of tests/test_backward_pallas.py:46-67
with a leading lane dimension) is shared with test_torch_backward.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddo_tpu_torch.engine import backward as tbwd
from ddo_tpu_torch.ops import sort as tsort
from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import INF, NEG_INF

NAMES = ["vb", "mk", "th", "hs"]


def random_case(rng, n, W, D, K):
    """numpy planes with a leading K (tests/test_backward_pallas.py:46-67)."""
    C = W * D
    ec = rng.integers(-1, W, (K, n, C)).astype(np.int32)
    eco = rng.integers(-20, 20, (K, n, C)).astype(np.int32)
    ev = rng.random((K, n, C)) < 0.6
    val = rng.integers(-50, 50, (K, n, W)).astype(np.int32)
    rub = rng.integers(0, 60, (K, n, W)).astype(np.int32)
    cutf = rng.random((K, n, W)) < 0.2
    exact = rng.random((K, n, W)) < 0.5
    mask = rng.random((K, n, W)) < 0.8
    vb_init = np.where(rng.random((K, W)) < 0.5,
                       rng.integers(-5, 5, (K, W)), NEG_INF).astype(np.int32)
    th_init = np.where(rng.random((K, W)) < 0.5,
                       rng.integers(-30, 30, (K, W)), INF).astype(np.int32)
    ep = np.where(rng.random((K, n, W)) < 0.2,
                  rng.integers(-30, 30, (K, n, W)), INF).astype(np.int32)
    wlp = rng.random((K, n, W)) < 0.15
    wlth = np.where(wlp, rng.integers(-30, 30, (K, n, W)), INF).astype(np.int32)
    best_known = rng.integers(-20, 40, K).astype(np.int32)
    return ([ec, eco, ev, val, rub, cutf, exact, mask, vb_init, th_init],
            best_known, [ep, wlp, wlth])


def sort_operands(L, C, nk, npay, seed):
    rng = np.random.default_rng(seed)
    ops = [rng.integers(-40, 40, (L, C)).astype(np.int32) for _ in range(nk + npay)]
    # unique final key => total order => one correct answer
    ops[nk - 1] = np.tile(rng.permutation(C).astype(np.int32), (L, 1))
    return ops


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need an NVIDIA GPU")


def _sorted_on_card(ops, nk, route=None):
    """K1 on `ops`, checking it counted one call, on the route taken."""
    before = trace.counted("lane_sort")
    taken = route or tsort.lane_sort_route(nk, ops[0].shape[1])
    on_route = trace.counted("lane_sort." + taken)
    got = tsort.multi_sort_cuda(ops, nk, route=route)
    torch.cuda.synchronize()
    assert trace.counted("lane_sort") == before + 1  # one call for any operand count
    assert trace.counted("lane_sort." + taken) == on_route + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,nk,npay,seed", [
    (8, 300, 4, 3, 0),     # non-pow2 C
    (1, 64, 2, 0, 1),      # one lane
    (5, 257, 1, 6, 2),     # one key, many payloads
    (8, 128, 6, 2, 3),
    (128, 512, 4, 4, 5),   # knapsack sort-1 at real size
    (128, 512, 4, 0, 6),   # knapsack sort-2 at real size
    (3, 700, 2, 40, 7),    # 42 operands in one launch
    (4, 2, 1, 1, 8),       # C2 = 2: the rest of the warp's 64 rows are pads
    (3, 32, 2, 1, 9),      # C2 = 32: within one warp
    (3, 64, 3, 2, 10),     # C2 = 64: one full warp, no exchange
    (2, 128, 8, 1, 11),    # C2 = 128: the first shared-memory exchange, REGS_MAX_KEYS keys
    (2, 256, 5, 1, 15),    # C2 = 256
    (2, 2048, 4, 1, 12),   # C2 = 2048: the "regs" route's 1024 threads
    (2, 4096, 2, 1, 13),   # C2 = 4096: the "perm" route
    (4, 200, 9, 2, 14),    # one key above REGS_MAX_KEYS: the "perm" route
    (128, 512, 10, 11, 16),  # MISP sort-1 at real size (7 state words): "perm"
    (128, 512, 11, 0, 17),   # MISP sort-2 at real size: "perm"
])
def test_lane_sort_matches_plain_on_card(L, C, nk, npay, seed):
    _card()
    ops = [torch.from_numpy(o).cuda() for o in sort_operands(L, C, nk, npay, seed)]
    ref = tsort.multi_sort_plain(ops, nk)
    got = _sorted_on_card(ops, nk)
    for r, g in zip(ref, got):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("nk", range(1, tsort.REGS_MAX_KEYS + 2))
@pytest.mark.parametrize("route", ["regs", "perm"])
def test_lane_sort_routes_agree_on_card(nk, route):
    """Every key count of the "regs" route and one above, on both routes
    where they apply."""
    _card()
    if route == "regs" and nk > tsort.REGS_MAX_KEYS:
        with pytest.raises(ValueError, match="route"):
            tsort.multi_sort_cuda([torch.zeros((1, 8), dtype=torch.int32).cuda()] * nk,
                                  nk, route=route)
        return
    ops = [torch.from_numpy(o).cuda() for o in sort_operands(6, 300, nk, 2, 20 + nk)]
    ref = tsort.multi_sort_plain(ops, nk)
    for r, g in zip(ref, _sorted_on_card(ops, nk, route)):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("C,nk", [(2, 1), (32, 3), (64, 2), (128, 8), (300, 4), (4096, 2)])
def test_lane_sort_ties_on_card(C, nk):
    """Tied keys (a small value range): only the key operands are
    determined (`sort_lanes`' contract), on whichever route the shape
    takes."""
    _card()
    rng = np.random.default_rng(C + nk)
    ops = [torch.from_numpy(rng.integers(0, 3, (5, C)).astype(np.int32)).cuda()
           for _ in range(nk + 2)]
    ref = tsort.multi_sort_plain(ops, nk)
    got = _sorted_on_card(ops, nk)
    for r, g in zip(ref[:nk], got[:nk]):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,nk,npay", [(1, 512, 4, 4), (1, 5376, 11, 8), (4, 300, 9, 2)])
def test_lane_sort_into_out_on_card(L, C, nk, npay):
    """K1 writes into a given `out` on every route (the compile's layer
    graphs read it there): the same sorted operands, as views of `out`;
    an `out` of another shape, dtype or layout is refused."""
    _card()
    ops = [torch.from_numpy(o).cuda() for o in sort_operands(L, C, nk, npay, 90 + nk)]
    out = torch.empty((nk + npay, L, C), dtype=torch.int32, device="cuda")
    got = tsort.multi_sort(ops, nk, out=out)
    for r, g, o in zip(tsort.multi_sort_plain(ops, nk), got, out.unbind(0)):
        assert torch.equal(r, g) and g.data_ptr() == o.data_ptr()
    strided = torch.empty((nk + npay, L, 2 * C), dtype=torch.int32, device="cuda")[..., ::2]
    for bad in (out[:-1], out.to(torch.int64), strided):
        with pytest.raises(ValueError, match="out must be"):
            tsort.multi_sort_cuda(ops, nk, out=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["regs", "perm"])
def test_lane_sort_sentinel_keys_on_card(route):
    """Real keys equal to the pad rows' 2^31-1 never let a pad into the
    output (C = 300 pads to 512)."""
    _card()
    rng = np.random.default_rng(3)
    big = np.iinfo(np.int32).max
    keys = [np.full((4, 300), big, np.int32),
            np.where(rng.random((4, 300)) < 0.5, big, 0).astype(np.int32),
            np.tile(rng.permutation(300).astype(np.int32), (4, 1))]
    ops = [torch.from_numpy(o).cuda() for o in keys + [rng.integers(0, 9, (4, 300))
                                                         .astype(np.int32)]]
    ref = tsort.multi_sort_plain(ops, 3)
    for r, g in zip(ref, _sorted_on_card(ops, 3, route)):
        assert torch.equal(r, g)


@pytest.mark.cuda
def test_lane_sort_strided_operands_on_card():
    """Column slices and a lane-broadcast key are read in place."""
    _card()
    rng = np.random.default_rng(4)
    wide = torch.from_numpy(rng.integers(-9, 9, (6, 400, 3)).astype(np.int32)).cuda()
    idx = torch.from_numpy(-rng.permutation(400).astype(np.int32)).cuda().expand(6, 400)
    ops = [wide[:, :, 0], wide[:, :, 1], idx, wide[:, :, 2]]
    assert not any(o.is_contiguous() for o in ops)
    ref = tsort.multi_sort_plain(ops, 3)
    for r, g in zip(ref, _sorted_on_card(ops, 3)):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,nk,npay,seed", [
    (2, 1, 1, 1, 30),          # C = 1
    (3, 1023, 3, 2, 31),       # C = T - 1 (T = 1024 rows per tile)
    (3, 1024, 3, 2, 32),       # C = T
    (3, 1025, 3, 2, 33),       # C = T + 1: a merge pass over a run of one row
    (4, 5000, 11, 7, 34),      # C not a power of two, TSPTW's 11 keys
    (128, 15_616, 11, 7, 35),  # TSPTW N60 sort-1 at width 256
    (128, 15_616, 4, 0, 36),   # TSPTW N60 sort-2
    (1, 97_280, 39, 5, 37),    # SOP-380 at width 256, one lane
    (16, 3840, 64, 6, 38),     # SRFLP n=60: 70 operands
    (128, 5376, 13, 8, 39),    # LCS 10 strings x 20 letters
    (2, 700, 120, 8, 40),      # 128 operands, tiles of 256 rows
])
def test_lane_sort_merge_matches_plain_on_card(L, C, nk, npay, seed):
    """The "merge" route at every tile boundary and at the new models'
    sort shapes, bit-equal to the plain version."""
    _card()
    ops = [torch.from_numpy(o).cuda() for o in sort_operands(L, C, nk, npay, seed)]
    ref = tsort.multi_sort_plain(ops, nk)
    for r, g in zip(ref, _sorted_on_card(ops, nk, "merge")):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("C,nk", [(1, 1), (3000, 2), (20_000, 5)])
def test_lane_sort_merge_ties_and_strides_on_card(C, nk):
    """Keys drawn from {0, 1}, with no unique final key: the position
    breaks every tie, so every operand, payloads included, equals the
    stable plain version's; the operands are column slices of one array
    and a lane-broadcast key, read in place."""
    _card()
    rng = np.random.default_rng(C + nk)
    wide = torch.from_numpy(rng.integers(0, 2, (5, C, nk + 2)).astype(np.int32)).cuda()
    ops = [wide[:, :, t] for t in range(nk + 2)]
    ops[0] = torch.from_numpy(rng.integers(0, 2, C).astype(np.int32)).cuda().expand(5, C)
    ref = tsort.multi_sort_plain(ops, nk)
    for r, g in zip(ref, _sorted_on_card(ops, nk, "merge")):
        assert torch.equal(r, g)


def test_lane_sort_route_choice():
    """The route by shape: registers up to REGS_MAX_KEYS keys and 2048
    padded rows; the same network up to PERM_MAX_ROWS past them, with the
    key words past PREFIX_WORDS staged in shared memory; the multi-CTA
    merge beyond; and a refusal past MAX_OPERANDS keys or the merge
    route's rows."""
    route = tsort.lane_sort_route
    assert route(4, 512) == route(1, 1) == route(8, 2048) == route(1, 2) == "regs"
    assert route(4, 2048, 1) == route(4, 16, 16) == "regs"  # one lane; a tiny lane
    assert route(9, 512) == route(12, 1024) == route(42, 700) == "perm"
    assert route(10, 512, 128) == route(11, 512, 128) == "perm"  # MISP at 200 vertices
    assert route(11, 1024, 1) == route(12, 33) == route(138, 33, 16) == "perm"
    # tiny lanes past 8 keys: max2sat at 16, 135 and 220 variables, 16 or
    # 4 lanes of 16 or 32 rows (W=8, W=16)
    assert route(19, 16, 16) == route(138, 32, 4) == route(223, 32, 4) == "merge"
    # lanes past the network: LCS (C ~ 28k), TSPTW N60 at width 256,
    # SOP-380 at width 256 in one lane, golomb-12, the device loop's slab
    for nk, C, L in [(40, 4096, 1), (2, 28_000, 1), (11, 15_616, 128), (4, 15_616, 128),
                     (39, 97_280, 1), (128, 1000, 1), (9, 2048, 1), (4, 8192, 1),
                     (138, 512, 128)]:
        assert route(nk, C, L) == "merge"
    with pytest.raises(ValueError, match="512 operands"):
        route(513, 8)
    assert route(2, tsort.MERGE_MAX_ROWS) == "merge"
    with pytest.raises(ValueError, match="merge route"):
        route(2, tsort.MERGE_MAX_ROWS + 1)


@pytest.mark.parametrize("L,C,nk,plan", [
    # (prefix words, tile rows, window rows, passes, tile / pass / gather
    # smem bytes)
    (128, 15_616, 11, (11, 4096, 4096, 2, 196_608, 204_808, 62_464)),  # TSPTW N60 sort-1
    (128, 15_616, 4, (4, 8192, 4096, 1, 163_840, 90_120, 62_464)),     # TSPTW N60 sort-2
    (1, 97_280, 39, (12, 2048, 256, 6, 106_496, 13_832, 0)),          # SOP-380: no staging
    (16, 3840, 67, (12, 2048, 256, 1, 106_496, 13_832, 15_360)),      # SRFLP-60
    (128, 5376, 13, (12, 4096, 2048, 1, 212_992, 110_600, 21_504)),   # LCS 10 x 20
    (1, 8192, 4, (4, 2048, 256, 2, 40_960, 5_640, 32_768)),           # the slab's pop sort
    (8, 50_000, 11, (11, 4096, 1024, 4, 196_608, 51_208, 200_000)),
    (128, 4096, 11, (11, 4096, 1024, 0, 196_608, 0, 0)),             # one tile
    (128, 4097, 11, (11, 4096, 2048, 1, 196_608, 102_408, 16_388)),   # a tile of one row
    (8, 2049, 11, (11, 2048, 256, 1, 98_304, 12_808, 8_196)),         # a window of one row
    (8, 1, 3, (3, 256, 256, 0, 4_096, 0, 0)),
    (8, 1, 1, (1, 256, 256, 0, 3_072, 0, 0)),                         # a head of (key, position)
    (16, 16, 141, (12, 256, 256, 0, 13_312, 0, 0)),                   # past 12 keys
])
def test_merge_plan(L, C, nk, plan):
    """The "merge" route's plan per (lanes, rows, keys): tiles and windows
    are powers of two within one block's shared memory, a window never
    exceeds a tile, the passes double the run length from a tile to the
    lane, and a gather pass stages one operand's lane when it fits a
    block."""
    got = tsort.merge_plan(L, C, nk)
    assert tuple(got) == plan
    P, T, S, passes, tile_smem, pass_smem, gather_smem = got
    assert P == min(nk, tsort.PREFIX_WORDS)
    assert tsort.MERGE_MIN_ROWS <= S <= T <= tsort.MERGE_MAX_TILE
    assert T & (T - 1) == 0 and S & (S - 1) == 0
    assert T * 2 ** passes >= C > (T * 2 ** (passes - 1) if passes else 0)
    # a 64-bit head of two record words per row, the other words, index
    # buffers (two per tile, one per window), and a window's two splits
    assert tile_smem == T * (8 + 4 * max(P - 2, 0) + 2 * 2) <= tsort.cuda_build.SMEM_PER_BLOCK
    if passes:
        assert pass_smem == S * (8 + 4 * (P - 1) + 2) + 8 <= tsort.cuda_build.SMEM_PER_BLOCK
    assert gather_smem in (0, 4 * C) and gather_smem <= tsort.cuda_build.SMEM_PER_BLOCK
    assert bool(gather_smem) == (passes > 0 and 4 * C <= tsort.cuda_build.SMEM_PER_BLOCK)


def test_lane_sort_wrapper_refusals():
    """What the K1 wrapper refuses, decided without a card: too many
    operands, a bad key count, a route the shape does not take, and CPU
    tensors, also given to the engine's sort with an output buffer."""
    op = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="with out="):
        tsort.multi_sort([op], 1, out=torch.empty((1, 2, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="operands exceed"):
        tsort.multi_sort_cuda([op] * (tsort.MAX_OPERANDS + 1), 1)
    with pytest.raises(ValueError, match="num_keys"):
        tsort.multi_sort_cuda([op] * 2, 3)
    with pytest.raises(ValueError, match="route"):
        tsort.multi_sort_cuda([op] * 10, 9, route="regs")
    with pytest.raises(ValueError, match="route"):
        tsort.multi_sort_cuda([op], 1, route="radix")
    with pytest.raises(ValueError, match="route"):  # past the network's rows
        tsort.multi_sort_cuda([torch.zeros((1, 2048), dtype=torch.int32)] * 9, 9,
                              route="perm")
    with pytest.raises(ValueError, match="route"):  # staged keys past shared memory
        tsort.multi_sort_cuda([torch.zeros((1, 1000), dtype=torch.int32)] * 128, 128,
                              route="perm")
    with pytest.raises(ValueError, match="CUDA device"):
        tsort.multi_sort_cuda([op] * tsort.MAX_OPERANDS, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,nk,npay,route", [
    (3, 100, 4, 125, "regs"),    # 129 operands, few keys
    (3, 100, 4, 125, "merge"),
    (16, 16, 138, 3, "perm"),    # max2sat at 135 variables, W=8: 141 operands
    (16, 16, 138, 3, "merge"),
    (16, 16, 223, 3, "perm"),    # max2sat at 220 variables: 226 operands
    (4, 512, 223, 3, "merge"),
    (2, 700, 500, 12, "merge"),  # the cap: 512 operands
    (2, 64, 500, 12, "perm"),
])
def test_lane_sort_many_operands_on_card(L, C, nk, npay, route):
    """Past the 128 operands of the small parameter struct, on each route
    that takes the shape: bit-equal to the plain version."""
    _card()
    ops = [torch.from_numpy(o).cuda() for o in sort_operands(L, C, nk, npay, 50 + nk)]
    ref = tsort.multi_sort_plain(ops, nk)
    for r, g in zip(ref, _sorted_on_card(ops, nk, route)):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,nk,route", [
    (4, 300, 16, "perm"), (4, 1000, 16, "perm"), (16, 16, 138, "perm"),
    (4, 300, 16, "merge"), (8, 5000, 16, "merge"), (4, 3000, 40, "merge"),
])
def test_lane_sort_prefix_ties_on_card(L, C, nk, route):
    """Keys that tie on the PREFIX_WORDS words a record carries (each from
    {0, 1}) and differ only later: the staged or re-read key words settle
    them, and the position settles the rest, so every operand, payloads
    included, equals the stable plain version's."""
    _card()
    rng = np.random.default_rng(C + nk)
    keys = [rng.integers(0, 2, (L, C)) for _ in range(tsort.PREFIX_WORDS)]
    keys += [rng.integers(-3, 3, (L, C)) for _ in range(nk - tsort.PREFIX_WORDS)]
    ops = [torch.from_numpy(o.astype(np.int32)).cuda()
           for o in keys + [rng.integers(0, 1 << 20, (L, C)) for _ in range(2)]]
    ref = tsort.multi_sort_plain(ops, nk)
    for r, g in zip(ref, _sorted_on_card(ops, nk, route)):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,nk", [
    (128, 4096, 11), (128, 4097, 11),  # one tile; a second tile of one row
    (128, 8193, 4),                    # tiles of 8,192 rows
    (8, 2049, 11),                     # windows of 256 rows, one of one row
    (2, 2048 * 3 + 1, 2),              # tiles of 2,048, two passes
    (1, 97_280, 39),                   # SOP-380: six passes, no staged gather
    (1, 60_000, 3),                    # a lane past a staged gather
])
def test_lane_sort_merge_tile_boundaries_on_card(L, C, nk):
    """The "merge" route at its plan's tile and window boundaries (see
    test_merge_plan), bit-equal to the plain version."""
    _card()
    ops = [torch.from_numpy(o).cuda() for o in sort_operands(L, C, nk, 3, 70 + nk)]
    ref = tsort.multi_sort_plain(ops, nk)
    for r, g in zip(ref, _sorted_on_card(ops, nk, "merge")):
        assert torch.equal(r, g)


def _backward_on_card(K, n, W, D, seed, filters=True, **force):
    """K2 against `backward_scans` on the card, bit for bit; returns the
    route it launched on (one launch, counted once, on that route and, on
    "stream", once at its plan's cluster size)."""
    _card()
    args, bk, extras = random_case(np.random.default_rng(seed), n, W, D, K)
    t = [torch.from_numpy(a).cuda() for a in args + [bk] + (extras if filters else [])]
    ref = tbwd.backward_scans(*t)
    routes = lambda: {r: trace.counted("fused_backward." + r) for r in tbwd.ROUTES}
    clusters = lambda: {c: trace.counted(f"fused_backward.stream.{c}")
                        for c in tbwd.CLUSTERS_RESIDENT}
    before, by_route, by_cluster = trace.counted("fused_backward"), routes(), clusters()
    got = tbwd.fused_backward_cuda(*t, **force)
    torch.cuda.synchronize()
    assert trace.counted("fused_backward") == before + 1
    after = routes()
    taken = [r for r in tbwd.ROUTES if after[r] != by_route[r]]
    assert len(taken) == 1 and after[taken[0]] == by_route[taken[0]] + 1
    clusters = {c: m - by_cluster[c] for c, m in clusters().items() if m != by_cluster[c]}
    if taken[0] == "stream":
        assert clusters == {tbwd.backward_plan(K, W, D, **force).cluster: 1}
    else:
        assert not clusters
    for r, g, name in zip(ref, got, NAMES):
        assert torch.equal(r, g), name
    return taken[0]


@pytest.mark.cuda
@pytest.mark.parametrize("K,n,W,D", [
    (1, 7, 16, 3), (4, 6, 8, 3), (128, 200, 256, 2), (2, 5, 1100, 2),
    (3, 1, 16, 1), (3, 2, 32, 3), (2, 3, 64, 2),  # TMA ring, n below its block
    (2, 21, 256, 2),                             # TMA ring, a partial last block
    (1, 3, 2048, 2),                             # TMA ring, blocks of one layer
    (3, 1, 7, 1), (3, 2, 7, 3), (3, 3, 7, 1),    # direct route: rows not 16-byte multiples
    (2, 3, 1100, 3), (2, 9, 1100, 1),            # direct route, W beyond one block
    (1, 3, 4096, 2),                             # stream route: two layers do not fit
])
def test_fused_backward_matches_plain_on_card(K, n, W, D):
    route = _backward_on_card(K, n, W, D, K * 1000 + W)
    assert route == tbwd.backward_plan(K, W, D).route


@pytest.mark.cuda
@pytest.mark.parametrize("filters", [True, False])
@pytest.mark.parametrize("K,n,W,D,cluster", [
    (128, 3, 256, 61, None),   # TSPTW N60's D, one CTA per lane
    (4, 6, 256, 61, None),     # four lanes: clusters of 16
    (1, 5, 256, 380, None),    # SOP with 380 jobs, one lane
    (16, 4, 256, 60, None),    # SRFLP n=60: clusters of 8
    (1, 9, 256, 61, None),     # one lane
    (4, 1, 256, 61, None),     # n below the ring depth (25 chunks)
    (2, 2, 256, 2, None),      # n below the ring depth, low branching
    (2, 7, 256, 61, 1), (2, 7, 256, 61, 2), (2, 7, 256, 61, 4),
    (2, 7, 256, 61, 8), (2, 7, 256, 61, 16),  # every cluster size
    (3, 5, 16, 1, 1),          # one lane per node (G = 1)
    (3, 5, 16, 9, 1),          # groups of 16 lanes
    (3, 4, 64, 3, 2),          # groups of 4 lanes, a cluster of 2
    (2, 4, 4096, 2, None),     # very wide layers: 16 CTAs x 256 slots
    (1, 30, 256, 2, 16),       # the one-lane knapsack shape, spread out
    (2, 3, 8192, 1, 1),        # chunks of 512 slots, a lane per node
])
def test_fused_backward_stream_on_card(K, n, W, D, cluster, filters):
    """The "stream" route (sub-layer chunks through a ring, a cluster per
    lane) against `backward_scans`, forced where "tma" would win."""
    route = _backward_on_card(K, n, W, D, 7 * K + n + D, filters, route="stream",
                              cluster=cluster)
    assert route == "stream"


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
@pytest.mark.parametrize("K,n,W,D,cluster", [
    (3, 4, 256, 61, 1),     # TSPTW N60's D: a warp per node
    (1, 3, 256, 380, 16),   # SOP with 380 jobs in a cluster of 16
    (2, 3, 256, 9, 1),      # groups of 16 lanes
])
def test_fused_backward_stream_unroll_on_card(K, n, W, D, cluster, unroll):
    """Every instance of the "stream" kernel (node passes in flight; with
    a warp per node and more than one pass, the reduce-scatter) at shapes
    where the planner picks another, against `backward_scans`."""
    route = _backward_on_card(K, n, W, D, 11 * K + n + unroll, cluster=cluster, unroll=unroll)
    assert route == "stream"


@pytest.mark.parametrize("K,W,D,route,block,cluster", [
    (128, 256, 2, "tma", 8, 1), (1, 16, 1, "tma", 16, 1), (4, 64, 3, "tma", 16, 1),
    (128, 2048, 2, "tma", 1, 1), (16, 8, 2, "direct", 0, 1), (3, 7, 1, "direct", 0, 1),
    (8, 1100, 3, "direct", 0, 1),
    (4, 4096, 2, "stream", 256, 16),   # was "direct" before the stream route
    (128, 256, 61, "stream", 128, 1),  # TSPTW N60: chunks of 128 slots, 3 in the ring
    (4, 256, 61, "stream", 16, 16),
    (1, 256, 380, "stream", 16, 16),   # SOP, 380 jobs
    (16, 256, 60, "stream", 64, 4),    # SRFLP n=60: 16 clusters of 8 would not all fit
    (7, 256, 60, "stream", 16, 16), (8, 256, 60, "stream", 32, 8),
    (30, 256, 60, "stream", 64, 4), (31, 256, 60, "stream", 128, 2),
    (67, 256, 60, "stream", 128, 1), (2, 64, 200, "stream", 16, 4),
    (1, 32, 61, "tma", 4, 1),
    (1, 256, 800, "direct", 0, 1),     # not even two chunks of 16 slots fit
])
def test_backward_plan(K, W, D, route, block, cluster):
    """K2's route by shape: "tma" with the most layers per block whose two
    blocks fit beside the carries, when rows are 16-byte multiples;
    "stream" where they do not, its chunks a multiple of 16 slots that
    divides each CTA's share, its cluster a power of two spread over at
    most 132 SMs; "direct" for the rest.  Every copy is a 16-byte multiple
    at a 16-byte offset, and the ring fits shared memory."""
    plan = tbwd.backward_plan(K, W, D)
    assert (plan.route, plan.block, plan.cluster) == (route, block, cluster)
    assert plan.smem <= tbwd.cuda_build.SMEM_PER_BLOCK
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    sizes = [b - a for a, b in zip(plan.layout, plan.layout[1:])]
    if route == "tma":
        rows = [4 * W * D] * 2 + [4 * W] * 4 + [W * D] + [W] * 4
        assert sizes == [block * r for r in rows]
        assert plan.smem == 16 * W + 2 * plan.layout[-1] + 16
    if route == "stream":
        S, R, c, G = plan.block, plan.depth, plan.cluster, plan.group
        assert S % 16 == 0 and W % (S * c) == 0
        assert c & (c - 1) == 0 and c <= tbwd.MAX_CLUSTER
        assert K * c <= tbwd.cuda_build.SM_COUNT
        assert R >= tbwd.STREAM_MIN_DEPTH or S == 16
        assert sizes == [4 * S * D] * 2 + [4 * S] * 4 + [S * D] + [S] * 4
        assert R >= 2 and plan.smem == (12 * R + 31) // 16 * 16 + 16 * W + R * plan.layout[-1]
        assert G == min(32, 1 << (D - 1).bit_length())
        nodes = -(-S // (plan.threads // 32))
        assert nodes <= 32  # a warp's nodes fit its lanes
        # as many node passes in flight as a warp has, up to 8
        passes = -(-nodes * G // 32)
        assert plan.unroll in tbwd.UNROLLS and plan.unroll <= max(1, passes)
        assert 2 * plan.unroll > min(passes, 8)
    else:
        assert plan.unroll == 1
    if route != "direct":
        assert all(o % 16 == 0 for o in plan.layout) and all(b % 16 == 0 for b in sizes)
    assert plan.ints()[0] == tbwd.ROUTES.index(route) and len(plan.ints()) == 19


def test_backward_plan_forced_routes():
    """A forced route or cluster is taken where it fits and refused where
    it does not; carries past shared memory are refused."""
    assert tbwd.backward_plan(128, 256, 2, "stream").route == "stream"
    assert tbwd.backward_plan(128, 256, 2, "direct").route == "direct"
    assert tbwd.backward_plan(4, 256, 61, cluster=2).cluster == 2
    wide = tbwd.backward_plan(200, 8192, 1, "stream")  # one lane per node, 512 a chunk
    assert (wide.block, wide.group, wide.threads) == (512, 1, 512)
    with pytest.raises(ValueError, match="does not take"):
        tbwd.backward_plan(128, 256, 61, "tma")
    with pytest.raises(ValueError, match="does not take"):
        tbwd.backward_plan(4, 8, 2, "stream")
    with pytest.raises(ValueError, match="no cluster"):
        tbwd.backward_plan(4, 256, 61, cluster=3)
    with pytest.raises(ValueError, match="no cluster"):
        tbwd.backward_plan(4, 256, 61, cluster=32)
    assert tbwd.backward_plan(128, 256, 61).unroll == 8
    assert tbwd.backward_plan(128, 256, 61, unroll=1).unroll == 1
    assert tbwd.backward_plan(128, 256, 2, unroll=2).route == "stream"
    with pytest.raises(ValueError, match="only the stream route"):
        tbwd.backward_plan(4, 256, 61, "tma", cluster=2)
    with pytest.raises(ValueError, match="only the stream route"):
        tbwd.backward_plan(4, 256, 61, "direct", unroll=1)
    with pytest.raises(ValueError, match="no unroll"):
        tbwd.backward_plan(4, 256, 61, unroll=3)
    with pytest.raises(ValueError, match="no route"):
        tbwd.backward_plan(4, 256, 61, "radix")
    with pytest.raises(ValueError, match="shared memory"):
        tbwd.backward_plan(1, 16_000, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n,W,D", [(3, 9, 32, 2), (4, 3, 256, 61)])
def test_fused_backward_misaligned_planes_on_card(K, n, W, D):
    """A plane that starts off a 16-byte boundary takes the direct route
    at a width a bulk-copy route ("tma", "stream") would take; forcing a
    bulk-copy route on it raises."""
    _card()
    rng = np.random.default_rng(5)
    args, bk, extras = random_case(rng, n, W, D, K)
    t = [torch.from_numpy(a).cuda() for a in args + [bk] + extras]
    shifted = torch.empty(t[3].numel() + 1, dtype=torch.int32, device="cuda")[1:]
    t[3] = shifted.view(t[3].shape).copy_(t[3])
    assert t[3].data_ptr() % 16 and t[3].is_contiguous()
    ref = tbwd.backward_scans(*t)
    direct = trace.counted("fused_backward.direct")
    got = tbwd.fused_backward_cuda(*t)
    assert trace.counted("fused_backward.direct") == direct + 1
    for r, g, name in zip(ref, got, NAMES):
        assert torch.equal(r, g), name
    with pytest.raises(ValueError, match="16-byte"):
        tbwd.fused_backward_cuda(*t, route=tbwd.backward_plan(K, W, D).route)


def test_fused_backward_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    args, bk, extras = random_case(rng, 3, 8, 2, 2)
    t = [torch.from_numpy(a) for a in args + [bk] + extras]
    with pytest.raises(ValueError, match="E_child is on cpu, not on a CUDA device"):
        tbwd.fused_backward_cuda(*t)
