"""The port's per-lane multi-key sort (ddo_tpu_torch/ops/sort.py) against
ddo_tpu's: `jax.lax.sort` and the Pallas `sort_packed` / `sort_lanes`
kernels in interpret mode.  Inputs come from numpy seeds; every
comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from ddo_tpu.ops import sort_pallas as jsort
from ddo_tpu_torch.ops import sort as tsort

# test_sort_pallas.py's packed cases: non-pow2 C (sentinel padding), a
# single lane, scatter-style 1 key + many payloads
PACKED_CASES = [
    (8, 300, 4, 3, 0),
    (1, 64, 2, 0, 1),
    (5, 257, 1, 6, 2),
    (8, 128, 6, 2, 3),
]


def _ops(L, C, nk, npay, seed):
    rng = np.random.default_rng(seed)
    ops = [rng.integers(-40, 40, (L, C)).astype(np.int32) for _ in range(nk + npay)]
    # unique final key => total order => one correct answer
    ops[nk - 1] = np.tile(rng.permutation(C).astype(np.int32), (L, 1))
    return ops


@pytest.mark.parametrize("L,C,nk,npay,seed", PACKED_CASES)
def test_multi_sort_matches_lax_sort(L, C, nk, npay, seed):
    ops = _ops(L, C, nk, npay, seed)
    ref = jax.lax.sort(tuple(jnp.asarray(o) for o in ops), num_keys=nk,
                       is_stable=False, dimension=-1)
    got = tsort.multi_sort([torch.from_numpy(o) for o in ops], nk)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("L,C,nk,npay,seed", PACKED_CASES)
def test_sort_packed_matches_pallas_interpret(L, C, nk, npay, seed):
    ops = _ops(L, C, nk, npay, seed)
    ref = jsort.sort_packed([jnp.asarray(o) for o in ops], nk, interpret=True)
    got = tsort.sort_packed([torch.from_numpy(o) for o in ops], nk)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("L,C,nk,npay,seed", [
    (4, 64, 3, 2, 0),
    (2, 128, 1, 0, 1),
    (8, 32, 5, 3, 2),
    (1, 256, 2, 1, 3),
])
def test_sort_lanes_keys_match_pallas_interpret(L, C, nk, npay, seed):
    """Tied keys (small value range): only the key operands are
    determined, as in test_sort_pallas.py."""
    rng = np.random.default_rng(seed)
    ops = [rng.integers(0, 7, (L, C)).astype(np.int32) for _ in range(nk + npay)]
    ref = jsort.sort_lanes([jnp.asarray(o) for o in ops], nk, interpret=True)
    got = tsort.sort_lanes([torch.from_numpy(o) for o in ops], nk)
    for r, g in zip(ref[:nk], got[:nk]):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_sort_lanes_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tsort.sort_lanes([torch.zeros((1, 3), dtype=torch.int32)], 1)


def test_payload_rides_permutation():
    rng = np.random.default_rng(7)
    k = torch.from_numpy(rng.permutation(64)[None, :].astype(np.int32))
    got = tsort.multi_sort([k, k + 100], 1)
    assert torch.equal(got[0], torch.sort(k, dim=1).values)
    assert torch.equal(got[1] - 100, got[0])
