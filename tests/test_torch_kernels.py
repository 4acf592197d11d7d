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
    before = tsort.KERNEL_LAUNCHES
    taken = route or tsort.lane_sort_route(nk, ops[0].shape[1])
    on_route = tsort.ROUTE_LAUNCHES[taken]
    got = tsort.multi_sort_cuda(ops, nk, route=route)
    torch.cuda.synchronize()
    assert tsort.KERNEL_LAUNCHES == before + 1  # one call for any operand count
    assert tsort.ROUTE_LAUNCHES[taken] == on_route + 1
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
    padded rows, the permutation in shared memory beyond, the multi-CTA
    merge past shared memory, and a refusal past MAX_OPERANDS keys or the
    merge route's rows."""
    route = tsort.lane_sort_route
    assert route(4, 512) == route(1, 1) == route(8, 2048) == route(1, 2) == "regs"
    assert route(9, 512) == route(4, 2049) == route(2, 4096) == route(42, 700) == "perm"
    assert route(10, 512) == route(11, 512) == "perm"  # MISP at 200 vertices
    # lanes whose keys pass one block's shared memory: LCS (C ~ 28k),
    # TSPTW N60 at width 256, SOP-380 at width 256 in one lane
    for nk, C in [(40, 4096), (2, 28_000), (11, 15_616), (39, 97_280), (128, 1000)]:
        assert route(nk, C) == "merge"
    with pytest.raises(ValueError, match="128 operands"):
        route(129, 8)
    assert route(2, tsort.MERGE_MAX_ROWS) == "merge"
    with pytest.raises(ValueError, match="merge route"):
        route(2, tsort.MERGE_MAX_ROWS + 1)


def test_lane_sort_wrapper_refusals():
    """What the K1 wrapper refuses, decided without a card: too many
    operands, a bad key count, a route the shape does not take, and CPU
    tensors."""
    op = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="operands exceed"):
        tsort.multi_sort_cuda([op] * (tsort.MAX_OPERANDS + 1), 1)
    with pytest.raises(ValueError, match="num_keys"):
        tsort.multi_sort_cuda([op] * 2, 3)
    with pytest.raises(ValueError, match="route"):
        tsort.multi_sort_cuda([op] * 10, 9, route="regs")
    with pytest.raises(ValueError, match="route"):
        tsort.multi_sort_cuda([op], 1, route="radix")
    with pytest.raises(ValueError, match="route"):  # keys past shared memory
        tsort.multi_sort_cuda([torch.zeros((1, 28_000), dtype=torch.int32)] * 2, 2,
                              route="perm")
    with pytest.raises(ValueError, match="CUDA device"):
        tsort.multi_sort_cuda([op] * tsort.MAX_OPERANDS, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n,W,D", [
    (1, 7, 16, 3), (4, 6, 8, 3), (128, 200, 256, 2), (2, 5, 1100, 2),
    (3, 1, 16, 1), (3, 2, 32, 3), (2, 3, 64, 2),  # TMA ring, n below its block
    (2, 21, 256, 2),                             # TMA ring, a partial last block
    (1, 3, 2048, 2),                             # TMA ring, blocks of one layer
    (3, 1, 7, 1), (3, 2, 7, 3), (3, 3, 7, 1),    # direct route: rows not 16-byte multiples
    (2, 3, 1100, 3), (2, 9, 1100, 1),            # direct route, W beyond one block
    (1, 3, 4096, 2),                             # direct route: two blocks do not fit
])
def test_fused_backward_matches_plain_on_card(K, n, W, D):
    _card()
    rng = np.random.default_rng(K * 1000 + W)
    args, bk, extras = random_case(rng, n, W, D, K)
    t = [torch.from_numpy(a).cuda() for a in args + [bk] + extras]
    ref = tbwd.backward_scans(*t)
    before = tbwd.KERNEL_LAUNCHES
    got = tbwd.fused_backward_cuda(*t)
    torch.cuda.synchronize()
    assert tbwd.KERNEL_LAUNCHES == before + 1
    for r, g, name in zip(ref, got, NAMES):
        assert torch.equal(r, g), name


def test_backward_plan():
    """K2's route by shape: the TMA ring with the most layers per block
    whose two blocks fit beside the carries, when rows are 16-byte
    multiples; else the direct route; a refusal past shared memory.  A
    slot holds each plane's B rows, 16-byte aligned."""
    for W, D, B in [(256, 2, 8), (16, 1, 16), (64, 3, 16), (2048, 2, 1), (8, 2, 0),
                    (7, 1, 0), (1100, 3, 0), (4096, 2, 0)]:
        block, layout = tbwd.backward_plan(W, D)
        assert block == B
        if block:
            C = W * D
            rows = [4 * C] * 2 + [4 * W] * 4 + [C] + [W] * 4
            assert [b - a for a, b in zip(layout, layout[1:])] == [B * r for r in rows]
            assert all(o % 16 == 0 for o in layout)
            assert 16 * W + 2 * layout[-1] + 16 <= tbwd.cuda_build.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        tbwd.backward_plan(16_000, 1)


@pytest.mark.cuda
def test_fused_backward_misaligned_planes_on_card():
    """A plane that starts off a 16-byte boundary takes the direct route
    at a width the TMA ring would take."""
    _card()
    rng = np.random.default_rng(5)
    args, bk, extras = random_case(rng, 9, 32, 2, 3)
    t = [torch.from_numpy(a).cuda() for a in args + [bk] + extras]
    shifted = torch.empty(t[3].numel() + 1, dtype=torch.int32, device="cuda")[1:]
    t[3] = shifted.view(t[3].shape).copy_(t[3])
    assert t[3].data_ptr() % 16 and t[3].is_contiguous()
    ref = tbwd.backward_scans(*t)
    got = tbwd.fused_backward_cuda(*t)
    for r, g, name in zip(ref, got, NAMES):
        assert torch.equal(r, g), name


def test_fused_backward_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    args, bk, extras = random_case(rng, 3, 8, 2, 2)
    t = [torch.from_numpy(a) for a in args + [bk] + extras]
    with pytest.raises(ValueError, match="is not on"):
        tbwd.fused_backward_cuda(*t)
