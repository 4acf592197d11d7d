"""The port's segment primitives (ddo_tpu_torch/ops/segments.py, native
indexing) against ddo_tpu's (one-hot contractions and sort inversions,
vmapped over lanes) on numpy-seeded inputs.  Every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from ddo_tpu.ops import segments as jseg
from ddo_tpu_torch.ops import segments as tseg


@pytest.mark.parametrize("K,C,seed", [(1, 16, 0), (4, 64, 1), (3, 300, 2)])
def test_head_broadcast_matches(K, C, seed):
    rng = np.random.default_rng(seed)
    head = rng.random((K, C)) < 0.3
    head[:, 3] = True
    vals = [rng.integers(-1000, 1000, (K, C)).astype(np.int32) for _ in range(2)]
    ref_pos = jax.vmap(jseg.run_head_positions)(jnp.asarray(head))
    np.testing.assert_array_equal(np.asarray(ref_pos),
                                  tseg.run_head_positions(torch.from_numpy(head)).numpy())
    ref = jax.vmap(lambda h, a, b: jseg.seg_broadcast_at_head(h, (a, b)))(
        jnp.asarray(head), *[jnp.asarray(v) for v in vals])
    got = tseg.seg_broadcast_at_head(torch.from_numpy(head),
                                     [torch.from_numpy(v) for v in vals])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("K,C,seed", [(1, 16, 0), (4, 64, 1), (3, 300, 2)])
def test_scatter_and_take_match(K, C, seed):
    rng = np.random.default_rng(seed)
    perm = np.stack([rng.permutation(C) for _ in range(K)]).astype(np.int32)
    vals = rng.integers(-(1 << 30), 1 << 30, (K, C)).astype(np.int32)
    ref = jax.vmap(lambda p, v: jseg.scatter_i32(p, v, C))(jnp.asarray(perm),
                                                          jnp.asarray(vals))
    got = tseg.scatter(torch.from_numpy(perm), torch.from_numpy(vals))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    idx = rng.integers(0, C, (K, 7)).astype(np.int32)
    ref = jax.vmap(jseg.take_i32)(jnp.asarray(vals), jnp.asarray(idx))
    got = tseg.take_rows(torch.from_numpy(vals), torch.from_numpy(idx))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_rev_cummin():
    x = torch.tensor([[5, 3, 4, 1, 2]], dtype=torch.int32)
    assert tseg.rev_cummin(x).tolist() == [[1, 1, 1, 1, 2]]
