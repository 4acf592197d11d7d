"""TSP with time windows in the shape of Dumas's sets.

Y. Dumas, J. Desrosiers, E. Gelinas, M. M. Solomon, "An optimal
algorithm for the traveling salesman problem with time windows",
Operations Research 43 (1995) 367-371: a depot and `n - 1` customers
uniform in a square of side `side`, Euclidean distances, and each
customer's window built around its arrival time a on a random tour, so
that the instance is feasible: its ends drawn uniformly from
[a - window/2, a] and [a, a + window/2], a width of up to `window`, as
Dumas draws them.  Distances and windows are float32 times `scale`,
truncated, as the reference's parser scales them.  The points, the tour
and the depot's window are a copy of
`ddo_tpu_torch.models.tsptw.generate_random` (commit b93b248), which
gives every window the width `window` instead.
"""

from __future__ import annotations

import numpy as np


def generate(params: dict, rng: np.random.Generator) -> dict:
    """One instance: int64 arrays `dist` [n, n], `twe` and `twl` [n]."""
    n, side = int(params["n"]), float(params["side"])
    scale = np.float32(params["scale"])
    scaled = lambda x: int(np.float32(x) * scale)
    xy = rng.uniform(0.0, side, (n, 2)).astype(np.float32)
    d = np.sqrt(((xy[:, None] - xy[None, :]) ** 2).sum(-1)).astype(np.float32)
    dist = (d * scale).astype(np.int64)
    tour = [0] + list(rng.permutation(np.arange(1, n))) + [0]
    w = scaled(params["window"])
    half = w // 2
    twe, twl = np.zeros(n, np.int64), np.zeros(n, np.int64)
    t = 0
    for a, b in zip(tour[:-2], tour[1:-1]):
        t += int(dist[a, b])
        left, right = rng.integers(0, half + 1, 2)
        twe[b], twl[b] = max(0, t - int(left)), t + int(right)
    t += int(dist[tour[-2], 0])
    twl[0] = t + w
    return {"dist": dist, "twe": twe, "twl": twl}


def port_model(inst: dict):
    """(problem, relaxation, ranking, dominance) of the port, built from
    the instance's arrays alone."""
    from ddo_tpu_torch.models import tsptw as ts

    pb = ts.Tsptw(inst["dist"], inst["twe"], inst["twl"])
    return pb, ts.TsptwRelax(pb), ts.TsptwRanking(), ts.TsptwDominance()
