"""Knapsack hook parity: the port's batch-first hooks
(ddo_tpu_torch/models/knapsack.py) against ddo_tpu's per-state hooks under
`jax.vmap`, on random states from numpy seeds.  Every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from ddo_tpu.core.types import root_subproblem as j_root, state_key_bytes as j_skb
from ddo_tpu.models import knapsack as jk
from ddo_tpu_torch.core.types import root_subproblem as t_root, state_key_bytes as t_skb
from ddo_tpu_torch.models import knapsack as tk


def _pair(seed, n=12):
    rng = np.random.default_rng(seed)
    profit = rng.integers(1, 60, n)
    weight = rng.integers(1, 25, n)
    jp = jk.Knapsack(int(weight.sum() // 2), profit, weight)
    return jp, tk.Knapsack.from_numpy(jp.capacity, jp.profit, jp.weight), rng


@pytest.mark.parametrize("seed", range(3))
def test_step_pack_rank_dominance_match(seed):
    jp, tp, rng = _pair(seed)
    B = 64
    caps = rng.integers(0, jp.capacity + 1, B).astype(np.int32)
    var = rng.integers(0, jp.nb_variables, B).astype(np.int32)
    depth = int(rng.integers(0, jp.nb_variables))
    jstep = jax.vmap(jax.vmap(
        lambda c, v, d: jp.step(jp.data, {"capacity": c}, v, d, depth),
        in_axes=(None, None, 0)), in_axes=(0, 0, None))
    jn, jc, jd, jv = jstep(jnp.asarray(caps), jnp.asarray(var),
                           jnp.arange(2, dtype=jnp.int32))
    states = {"capacity": torch.from_numpy(caps)}
    tn, tc, td, tv = tp.step(tp.data("cpu"), states, torch.from_numpy(var).long(), depth)
    np.testing.assert_array_equal(np.asarray(jn["capacity"]), tn["capacity"].numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())

    jstates = {"capacity": jnp.asarray(caps)}
    np.testing.assert_array_equal(np.asarray(jax.vmap(jp.pack)(jstates)),
                                  tp.pack(states).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda s: jk.KPRanking().score((), s))(jstates)),
        tk.KPRanking().score((), states).numpy())
    jdom, tdom = jk.KPDominance(), tk.KPDominance()
    np.testing.assert_array_equal(np.asarray(jax.vmap(jdom.key_cols)(jstates)),
                                  tdom.key_cols(states).numpy())
    np.testing.assert_array_equal(np.asarray(jax.vmap(jdom.coord_cols)(jstates)),
                                  tdom.coord_cols(states).numpy())


@pytest.mark.parametrize("seed", range(3))
def test_merge_matches(seed):
    jp, tp, rng = _pair(seed)
    B, C = 8, 16
    caps = rng.integers(0, jp.capacity + 1, (B, C)).astype(np.int32)
    mask = rng.random((B, C)) < 0.4
    ref = jax.vmap(lambda c, m: jk.KPRelax(jp).merge(jp.data, {"capacity": c}, m))(
        jnp.asarray(caps), jnp.asarray(mask))
    got = tk.KPRelax(tp).merge(tp.data("cpu"), {"capacity": torch.from_numpy(caps)},
                               torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(ref["capacity"]), got["capacity"].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_rub_matches_at_every_depth(seed):
    jp, tp, rng = _pair(seed, n=20)
    caps = np.concatenate([[0, jp.capacity], rng.integers(0, jp.capacity + 1, 62)]
                          ).astype(np.int32)
    jr, tr = jk.KPRelax(jp), tk.KPRelax(tp)
    data = tp.data("cpu")
    for depth in range(jp.nb_variables + 1):
        ref = jax.vmap(lambda c: jr.rub(jp.data, {"capacity": c}, depth))(jnp.asarray(caps))
        got = tr.rub(data, {"capacity": torch.from_numpy(caps)}, depth)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy(), err_msg=str(depth))


def test_subproblem_key_bytes_match():
    jp, tp, _ = _pair(0)
    assert t_root(tp).key == j_root(jp).key
    assert t_root(tp).value == j_root(jp).value
    np.testing.assert_array_equal(tp.unpack(np.frombuffer(t_root(tp).key, np.int32))
                                  ["capacity"], jp.capacity)
    state = {"depth": np.asarray(3, np.int32), "value": np.asarray([1, -2], np.int32)}
    assert t_skb(state) == j_skb(state)


def test_generator_and_dp():
    pb = tk.generate_uncorrelated(40, 1000, 1, 100, seed=3)
    assert pb.nb_variables == 40
    assert pb.capacity == int(pb.weight.sum()) // 101
    assert pb.profit.min() >= 1 and pb.profit.max() <= 1000
    # the DP agrees with brute force on a small instance
    small = tk.generate_uncorrelated(12, 50, 1, 2, seed=4)
    best = 0
    for m in range(1 << 12):
        sel = np.array([(m >> i) & 1 for i in range(12)], bool)
        if small.weight[sel].sum() <= small.capacity:
            best = max(best, int(small.profit[sel].sum()))
    assert tk.dp_optimum(small.capacity, small.profit, small.weight) == best
