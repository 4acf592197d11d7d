"""Bitset parity: every op of ddo_tpu_torch/ops/bitset.py against
ddo_tpu/ops/bitset.py on the same random words, bit 31 included, for
L = 1, 2 and 7 words.  ddo_tpu's words are uint32, the port's int32: they
cross with `.view`, so every comparison is exact on the bit patterns.
(`reverse_bits` and `shift_right_var` are not ported: the port's golomb
model indexes the bits directly, see tests/test_torch_models.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddo_tpu.ops import bitset as jb
from ddo_tpu_torch.ops import bitset as tb

LANES = [1, 2, 7]
B = 64


def _words(L, seed):
    """uint32 [B, L]: random words; rows 0-3 are all zeros, all ones, only
    bit 31 of every word, and everything but bit 31."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, (B, L), dtype=np.uint64).astype(np.uint32)
    w[0], w[1], w[2], w[3] = 0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF
    return w


def _t(w):
    return torch.as_tensor(np.ascontiguousarray(w).view(np.int32))


def _u(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _elems(L, seed):
    """One element per row, bits 0 and 31 of the first and last word among
    them."""
    v = np.random.default_rng(seed + 1).integers(0, 32 * L, B)
    v[:4] = [0, 31, 32 * L - 1, 32 * (L - 1)]
    return v


@pytest.mark.parametrize("L", LANES)
def test_full_empty_nb_lanes(L):
    for n in (32 * L, 32 * L - 1, 32 * (L - 1) + 1):
        assert tb.nb_lanes(n) == jb.nb_lanes(n) == L
        np.testing.assert_array_equal(_u(tb.full_set(n)), np.asarray(jb.full_set(n)))
        np.testing.assert_array_equal(tb.full_set_np(n).view(np.uint32),
                                      np.asarray(jb.full_set(n)))
        np.testing.assert_array_equal(_u(tb.empty_set(n)), np.asarray(jb.empty_set(n)))
        assert tb.full_set(n).dtype == torch.int32


@pytest.mark.parametrize("L", LANES)
def test_contains_insert_remove_singleton(L):
    w, v = _words(L, L), _elems(L, L)
    tv = torch.as_tensor(v)
    jw, jv = jnp.asarray(w), jnp.asarray(v, jnp.int32)
    np.testing.assert_array_equal(tb.contains(_t(w), tv).numpy(),
                                  np.asarray(jax.vmap(jb.contains)(jw, jv)))
    np.testing.assert_array_equal(_u(tb.insert(_t(w), tv)),
                                  np.asarray(jax.vmap(jb.insert)(jw, jv)))
    np.testing.assert_array_equal(_u(tb.remove(_t(w), tv)),
                                  np.asarray(jax.vmap(jb.remove)(jw, jv)))
    np.testing.assert_array_equal(
        _u(tb.singleton(32 * L, tv)),
        np.asarray(jax.vmap(lambda x: jb.singleton(32 * L, x))(jv)))


@pytest.mark.parametrize("L", LANES)
def test_set_algebra(L):
    a, b = _words(L, 10 + L), _words(L, 20 + L)[::-1]
    for name in ("union", "intersect", "difference"):
        np.testing.assert_array_equal(
            _u(getattr(tb, name)(_t(a), _t(b))),
            np.asarray(getattr(jb, name)(jnp.asarray(a), jnp.asarray(b))), err_msg=name)


@pytest.mark.parametrize("L", LANES)
def test_count_with_bit_31(L):
    w = _words(L, 30 + L)
    got = tb.count(_t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.vmap(jb.count)(jnp.asarray(w))))
    np.testing.assert_array_equal(got.numpy()[:4], [0, 32 * L, L, 31 * L])


@pytest.mark.parametrize("L", LANES)
def test_to_bits_from_bits_roundtrip(L):
    w = _words(L, 40 + L)
    for n in (32 * L, 32 * L - 5):
        bits = tb.to_bits(_t(w), n)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jb.to_bits(jnp.asarray(w), n)))
        np.testing.assert_array_equal(
            _u(tb.from_bits(bits, n)), np.asarray(jb.from_bits(jnp.asarray(bits.numpy()), n)))
    np.testing.assert_array_equal(_u(tb.from_bits(tb.to_bits(_t(w), 32 * L), 32 * L)), w)


@pytest.mark.parametrize("L", LANES)
def test_reductions(L):
    """or_reduce / and_reduce over the batch dim of [K, C, L] words, as the
    models' `merge` calls them."""
    w = _words(L, 50 + L).reshape(4, B // 4, L)
    for name in ("or_reduce", "and_reduce"):
        got = getattr(tb, name)(_t(w), dim=1)
        ref = jax.vmap(lambda x: getattr(jb, name)(x, axis=0))(jnp.asarray(w))
        np.testing.assert_array_equal(_u(got), np.asarray(ref), err_msg=name)


@pytest.mark.parametrize("L", LANES)
def test_weight_sum(L):
    n = 32 * L - 3
    w = _words(L, 60 + L)
    weights = np.random.default_rng(L).integers(1, 100, n).astype(np.int32)
    got = tb.weight_sum(_t(w), torch.as_tensor(weights), n)
    ref = jax.vmap(lambda s: jb.weight_sum(s, jnp.asarray(weights), n))(jnp.asarray(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
