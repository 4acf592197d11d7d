"""Kernels K1 (lane_sort) and K2 (fused_backward) of ddo_tpu_torch
against their plain PyTorch versions on an NVIDIA GPU, bit for bit.

This file imports neither jax nor ddo_tpu, so it also runs where only the
port is installed; on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py

Without a GPU every test here skips.  `random_case` (the random planes of
tests/test_backward_pallas.py:46-67 with a leading lane dimension) is
shared with test_torch_backward.py.
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


@pytest.mark.cuda
@pytest.mark.parametrize("L,C,nk,npay,seed", [
    (8, 300, 4, 3, 0),     # non-pow2 C
    (1, 64, 2, 0, 1),      # one lane
    (5, 257, 1, 6, 2),     # one key, many payloads
    (8, 128, 6, 2, 3),
    (128, 512, 4, 4, 5),   # knapsack sort-1 at real size
    (128, 512, 4, 0, 6),   # knapsack sort-2 at real size
    (3, 700, 2, 40, 7),    # 42 operands in one launch
])
def test_lane_sort_matches_plain_on_card(L, C, nk, npay, seed):
    _card()
    ops = [torch.from_numpy(o).cuda() for o in sort_operands(L, C, nk, npay, seed)]
    ref = tsort.multi_sort_plain(ops, nk)
    before = tsort.KERNEL_LAUNCHES
    got = tsort.multi_sort_cuda(ops, nk)
    torch.cuda.synchronize()
    assert tsort.KERNEL_LAUNCHES == before + 1  # one launch for any operand count
    for r, g in zip(ref, got):
        assert torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n,W,D", [(1, 7, 16, 3), (4, 6, 8, 3), (128, 200, 256, 2),
                                     (2, 5, 1100, 2)])
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
