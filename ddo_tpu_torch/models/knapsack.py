"""0/1 knapsack, batch-first: counterpart of `ddo_tpu/models/knapsack.py`.

Reference model: ddo/examples/knapsack/main.rs
  * state = remaining capacity (KnapsackState, main.rs:37-44)
  * domain = {leave out, take} (main.rs:93-99)
  * merge = max capacity (main.rs:150-152)
  * fast upper bound = greedy fractional relaxation over the
    profit/weight-sorted item order (main.rs:158-180), here one
    `torch.searchsorted` over the weight prefix sums plus gathers
  * ranking = capacity (main.rs:188-194)
  * dominance: key=depth, coordinate=capacity, use_value (main.rs:199-218)
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import (Dominance, Problem, Relaxation, StateRanking,
                                        depth_row)

I32 = torch.int32


class Knapsack(Problem):
    name = "knapsack"

    def __init__(self, capacity: int, profit, weight):
        self.capacity = int(capacity)
        self.profit = np.asarray(profit, np.int64)
        self.weight = np.asarray(weight, np.int64)
        self.nb_variables = len(self.profit)
        self.domain_size = 2
        # branch in decreasing profit/weight ratio (main.rs:66-67)
        ratio = -self.profit / np.maximum(self.weight, 1)
        self.order = np.argsort(ratio, kind="stable").astype(np.int32)
        self._data = {}

    @classmethod
    def from_numpy(cls, capacity, profit, weight) -> "Knapsack":
        """The port's model of the instance a ddo_tpu `Knapsack` holds
        (`pb.capacity`, `pb.profit`, `pb.weight`), so both packages solve
        the identical instance."""
        return cls(int(capacity), np.asarray(profit), np.asarray(weight))

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            o = self.order
            pw = np.concatenate([[0], np.cumsum(self.weight[o])])
            pp = np.concatenate([[0], np.cumsum(self.profit[o])])
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=I32, device=device)
            self._data[device] = dict(
                profit=t(self.profit),
                weight=t(self.weight),
                prefix_w=t(pw),
                prefix_p=t(pp),
                # profit/weight in branching order, padded with a
                # zero-profit item so `m = n` contributes no fraction
                ord_p=t(np.concatenate([self.profit[o], [0]])),
                ord_w=t(np.concatenate([self.weight[o], [1]])),
            )
        return self._data[device]

    def initial_state(self):
        return {"capacity": np.asarray(self.capacity, np.int32)}

    def var_order(self):
        return self.order

    def step(self, data, states, var, depth):
        cap = states["capacity"][:, None]  # [B, 1]
        w = data["weight"][var][:, None]
        take = torch.arange(self.domain_size, device=cap.device) == 1  # [D]
        valid = torch.where(take, cap >= w, True)
        ncap = torch.where(take & valid, cap - w, cap)
        cost = torch.where(take, data["profit"][var][:, None], 0).to(I32)
        dval = take.to(I32).expand_as(valid)
        return {"capacity": ncap}, cost, dval, valid

    def pack(self, states):
        return states["capacity"].reshape(-1, 1)


class KPRelax(Relaxation):
    """main.rs:147-181."""

    def __init__(self, problem: Knapsack):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        cap = torch.where(mask, states["capacity"], -1).amax(dim=1)
        return {"capacity": cap}

    def rub(self, data, states, depth):
        # greedy fractional bound from `depth` in ratio order: the items
        # taken whole are the longest order-consecutive run fitting in the
        # capacity, then one fractional item (integer floor)
        pw = data["prefix_w"]
        cap = states["capacity"]
        base_w = depth_row(pw, depth)
        # m = (# prefix entries <= target) - 1, never < depth (cap >= 0)
        m = torch.searchsorted(pw, base_w + cap, right=True) - 1
        whole = data["prefix_p"][m] - depth_row(data["prefix_p"], depth)
        rem = cap - (pw[m] - base_w)
        frac = torch.div(rem * data["ord_p"][m],
                         torch.clamp(data["ord_w"][m], min=1),
                         rounding_mode="floor")
        return (whole + frac).to(I32)


class KPRanking(StateRanking):
    """main.rs:188-194: larger capacity is more promising."""

    def score(self, data, states):
        return states["capacity"].reshape(-1, 1)

    def score_host(self, state):
        return int(np.asarray(state["capacity"]))


class KPDominance(Dominance):
    """main.rs:199-218: same depth, coordinate=capacity, value included."""

    use_value = True

    def key_cols(self, states):
        # depth is the store's partition key: every same-depth state is
        # comparable
        cap = states["capacity"]
        return torch.zeros((cap.shape[0], 0), dtype=I32, device=cap.device)

    def coord_cols(self, states):
        return states["capacity"].reshape(-1, 1).to(I32)


def read_instance(path: str) -> Knapsack:
    """Parses the `resources/knapsack` format (main.rs:267-299):
    first non-comment line `n capacity`, then n lines `profit weight`."""
    profit, weight = [], []
    n = capa = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("c"):
                continue
            parts = line.split()
            if n is None:
                n, capa = int(parts[0]), int(parts[1])
            else:
                if len(profit) >= n:
                    break
                profit.append(int(parts[0]))
                weight.append(int(parts[1]))
    return Knapsack(capa, profit, weight)


def generate_uncorrelated(n: int, R: int, h: int, S: int, seed: int) -> Knapsack:
    """Pisinger's uncorrelated family, the one `knapPI_1_*` comes from
    ("Where are the hard knapsack problems?", 2005): p_j and w_j uniform
    in [1, R], capacity c = floor(h / (S + 1) * sum(w)) for instance h of
    a series of S."""
    rng = np.random.default_rng(seed)
    profit = rng.integers(1, R + 1, n)
    weight = rng.integers(1, R + 1, n)
    return Knapsack(h * int(weight.sum()) // (S + 1), profit, weight)


def dp_optimum(capacity: int, profit, weight) -> int:
    """Exact 0/1-knapsack optimum by the O(n * capacity) numpy DP."""
    best = np.zeros(int(capacity) + 1, np.int64)
    for p, w in zip(np.asarray(profit, np.int64), np.asarray(weight, np.int64)):
        if w <= capacity:
            best[w:] = np.maximum(best[w:], best[: len(best) - w] + p)
    return int(best[-1])
