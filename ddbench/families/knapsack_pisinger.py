"""Pisinger's uncorrelated 0/1 knapsack family (`knapPI_1_n_R_h`).

D. Pisinger, "Where are the hard knapsack problems?", Computers &
Operations Research 32 (2005) 2271-2284: profits and weights uniform in
[1, R], and instance h of a series of S has the capacity
floor(h / (S + 1) * sum(w)).  The arithmetic is a copy of
`ddo_tpu_torch.models.knapsack.generate_uncorrelated` (commit b93b248),
drawing h as well from the instance's generator.
"""

from __future__ import annotations

import numpy as np


def generate(params: dict, rng: np.random.Generator) -> dict:
    """One instance: int64 arrays `profit`, `weight` and the `capacity`."""
    n, R, S = int(params["n"]), int(params["R"]), int(params["S"])
    h_lo, h_hi = params["h"]
    h = int(rng.integers(int(h_lo), int(h_hi) + 1))
    profit = rng.integers(1, R + 1, n).astype(np.int64)
    weight = rng.integers(1, R + 1, n).astype(np.int64)
    return {"capacity": np.int64(h * int(weight.sum()) // (S + 1)),
            "profit": profit, "weight": weight}


def port_model(inst: dict):
    """(problem, relaxation, ranking, dominance) of the port, built from
    the instance's arrays alone."""
    from ddo_tpu_torch.models import knapsack as kp

    pb = kp.Knapsack(int(inst["capacity"]), inst["profit"], inst["weight"])
    return pb, kp.KPRelax(pb), kp.KPRanking(), kp.KPDominance()
