"""The plain reference of the knapsack family, in NumPy: the optimum by
dynamic programming over capacities, a solution's replay, and the
control (the same DP restricted to a few labels, with no proof)."""

from __future__ import annotations

import numpy as np


def optimum(inst: dict) -> int:
    """The exact optimum by the O(n * capacity) DP; a frozen copy of
    `ddo_tpu_torch.models.knapsack.dp_optimum` (commit b93b248)."""
    capacity = int(inst["capacity"])
    best = np.zeros(capacity + 1, np.int64)
    for p, w in zip(np.asarray(inst["profit"], np.int64), np.asarray(inst["weight"], np.int64)):
        if w <= capacity:
            best[w:] = np.maximum(best[w:], best[: len(best) - w] + p)
    return int(best[-1])


def replay(inst: dict, vals, pset):
    """The profit of the solution (vals[i] = 1 takes item i), or None when
    it leaves an item undecided, decides one outside {0, 1}, or exceeds
    the capacity."""
    vals, pset = np.asarray(vals, np.int64), np.asarray(pset, bool)
    n = len(inst["profit"])
    if vals.shape != (n,) or pset.shape != (n,) or not pset.all():
        return None
    if not np.isin(vals, (0, 1)).all():
        return None
    take = vals == 1
    if int(inst["weight"][take].sum()) > int(inst["capacity"]):
        return None
    return int(inst["profit"][take].sum())


def control(inst: dict, width: int = 4):
    """The control put in the program's place: a restricted DP, which keeps
    the `width` most valuable labels (remaining capacity, value) after each
    item, items in decreasing profit/weight order, and reports its best as
    the proved optimum: a search that skips its proof.  Returns
    (objective, vals, pset)."""
    profit = np.asarray(inst["profit"], np.int64)
    weight = np.asarray(inst["weight"], np.int64)
    n = len(profit)
    labels = [(0, int(inst["capacity"]), ())]
    for i in np.argsort(-profit / weight, kind="stable").tolist():
        nxt = {}
        for value, room, taken in labels:
            nxt.setdefault(room, (value, room, taken))
            if weight[i] <= room:
                child = (value + int(profit[i]), room - int(weight[i]), taken + (i,))
                if child[1] not in nxt or nxt[child[1]][0] < child[0]:
                    nxt[child[1]] = child
        labels = sorted(nxt.values(), key=lambda x: (-x[0], -x[1]))[:width]
    vals = np.zeros(n, np.int64)
    vals[list(labels[0][2])] = 1
    return labels[0][0], vals, np.ones(n, bool)
