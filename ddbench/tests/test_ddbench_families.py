"""The families' generators and their plain references."""

import itertools

import numpy as np
import pytest

from ddbench import cell as cells

KP = {"n": 100, "R": 1000, "S": 100, "h": [1, 100]}
TS = {"n": 21, "side": 50.0, "window": 40.0, "scale": 10000.0}


def family(name):
    return (cells.load_file(f"{cells.HERE}/families/{name}.py"),
            cells.load_file(f"{cells.HERE}/families/{name}_ref.py"))


def rng(seed, i):
    return np.random.default_rng(np.random.SeedSequence(entropy=seed, spawn_key=(0, i)))


def same(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name, params", [("knapsack_pisinger", KP), ("tsptw_dumas", TS)])
def test_generator_deterministic_in_seed_and_index(name, params):
    gen, _ = family(name)
    for seed in (0, 7, 2**31 + 5):
        a = gen.generate(params, rng(seed, 3))
        assert same(a, gen.generate(params, rng(seed, 3)))
        assert not same(a, gen.generate(params, rng(seed, 4)))
        assert not same(a, gen.generate(params, rng(seed + 1, 3)))


def test_cell_streams_follow_the_seed():
    cell = cells.Cell("kp-uncorr-n100")
    a = cell.instance(2**31 + 9, cells.MEASURED, 5)
    assert same(a, cell.instance(2**31 + 9, cells.MEASURED, 5))
    assert not same(a, cell.instance(2**31 + 9, cells.WARMUP, 5))
    assert same(cell.instance(-3, cells.MEASURED, 0), cell.instance(-3, cells.MEASURED, 0))


def test_knapsack_instances_have_pisinger_shape():
    gen, _ = family("knapsack_pisinger")
    for i in range(20):
        inst = gen.generate(KP, rng(1, i))
        p, w = inst["profit"], inst["weight"]
        assert len(p) == len(w) == 100 and p.min() >= 1 and p.max() <= 1000
        assert 0 < inst["capacity"] <= 100 * int(w.sum()) // 101


def test_knapsack_reference_against_brute_force():
    gen, ref = family("knapsack_pisinger")
    for i in range(12):
        inst = gen.generate({**KP, "n": 10}, rng(2, i))
        best = 0
        for take in itertools.product((0, 1), repeat=10):
            t = np.array(take, bool)
            if inst["weight"][t].sum() <= inst["capacity"]:
                best = max(best, int(inst["profit"][t].sum()))
        assert ref.optimum(inst) == best


def test_knapsack_replay():
    _, ref = family("knapsack_pisinger")
    inst = {"capacity": 10, "profit": np.array([5, 4, 3]), "weight": np.array([6, 5, 4])}
    full = np.ones(3, bool)
    assert ref.replay(inst, [1, 0, 1], full) == 8
    assert ref.replay(inst, [1, 1, 0], full) is None  # over the capacity
    assert ref.replay(inst, [1, 0, 2], full) is None  # not a decision
    assert ref.replay(inst, [1, 0, 1], [True, False, True]) is None  # undecided


def tsptw_brute(inst):
    dist, twe, twl = inst["dist"], inst["twe"], inst["twl"]
    n, best = len(dist), None
    for perm in itertools.permutations(range(1, n)):
        t, cur, ok = 0, 0, True
        for j in (*perm, 0):
            t = max(t + int(dist[cur][j]), int(twe[j]))
            if t > twl[j]:
                ok = False
                break
            cur = j
        if ok and (best is None or t < best):
            best = t
    return None if best is None else -best


def test_tsptw_reference_against_brute_force():
    gen, ref = family("tsptw_dumas")
    for i in range(8):
        inst = gen.generate({**TS, "n": 7, "window": 100.0}, rng(3, i))
        assert ref.optimum(inst) == tsptw_brute(inst)
        value, vals, pset = ref.control(inst, width=10**6)
        assert value == ref.optimum(inst) == ref.replay(inst, vals, pset)


def test_tsptw_replay():
    _, ref = family("tsptw_dumas")
    inst = {"dist": np.array([[0, 2, 3], [2, 0, 4], [3, 4, 0]]),
            "twe": np.array([0, 0, 7]), "twl": np.array([20, 5, 8])}
    full = np.ones(3, bool)
    assert ref.replay(inst, [1, 2, 0], full) == -(2 + 4 + 1 + 3)  # waits at node 2 until 7
    assert ref.replay(inst, [2, 1, 0], full) is None  # node 1 reached at 7 > 5
    assert ref.replay(inst, [1, 1, 0], full) is None  # not a tour
    assert ref.replay(inst, [1, 2, 1], full) is None  # does not end at the depot


@pytest.mark.parametrize("name, params", [("knapsack_pisinger", KP), ("tsptw_dumas", TS)])
def test_control_misses_the_optimum_at_cell_size(name, params):
    gen, ref = family(name)
    missed = 0
    for i in range(30):
        inst = gen.generate(params, rng(4, i))
        value, vals, pset = ref.control(inst)
        opt = ref.optimum(inst)
        assert value is None or value <= opt
        missed += value != opt
    assert missed >= 3
