"""The plain reference of the TSPTW family, in NumPy and Python: the
optimum by a forward DP over (visited set, last node) labels, a tour's
replay, and the control (the same DP restricted to a few labels, with no
proof).  Objectives are the port's: minus the return time at the depot."""

from __future__ import annotations

import numpy as np


def _labels(dist, twe, twl):
    """The forward DP of `chip_smoke.py:tsptw_oracle` (commit b93b248),
    keeping each label's predecessor: {(visited mask, last): (earliest
    arrival, predecessor label)} after n - 1 moves.  The earliest arrival
    of each label is exact, since arriving later never helps.  A label
    dies when it misses a window, or when some node still to visit is out
    of reach even straight from here (the slack of n covers the truncation
    of scaled distances, so no feasible tour is cut)."""
    n = len(dist)
    layer, parents = {(1, 0): 0}, []
    for _ in range(n - 1):
        nxt, par = {}, {}
        for (mask, last), t in layer.items():
            for j in range(1, n):
                if mask >> j & 1:
                    continue
                a = max(t + int(dist[last][j]), int(twe[j]))
                m2 = mask | 1 << j
                if a > twl[j] or any(a + int(dist[j][k]) - n > twl[k]
                                     for k in range(1, n) if not m2 >> k & 1):
                    continue
                if a < nxt.get((m2, j), a + 1):
                    nxt[(m2, j)] = a
                    par[(m2, j)] = (mask, last)
        layer = nxt
        parents.append(par)
    return layer, parents


def _best_tour(dist, twe, twl):
    """(return time, tour) of the shortest tour, or None."""
    layer, parents = _labels(dist, twe, twl)
    best = None
    for (mask, last), t in layer.items():
        end = max(t + int(dist[last][0]), int(twe[0]))
        if end <= twl[0] and (best is None or end < best[0]):
            best = (end, (mask, last))
    if best is None:
        return None
    tour, label = [0], best[1]
    for par in reversed(parents):
        tour.append(label[1])
        label = par[label]
    return best[0], tour[::-1][:-1] + [0]


def optimum(inst: dict):
    """Minus the shortest return time, or None if no tour is feasible."""
    best = _best_tour(inst["dist"], inst["twe"], inst["twl"])
    return None if best is None else -best[0]


def replay(inst: dict, vals, pset):
    """Minus the return time of the tour vals[0], ..., vals[n-1] (every
    customer once, then the depot), or None when a position is undecided,
    the tour is no such tour, or it misses a window."""
    dist, twe, twl = inst["dist"], inst["twe"], inst["twl"]
    n = len(dist)
    vals, pset = np.asarray(vals, np.int64), np.asarray(pset, bool)
    if vals.shape != (n,) or pset.shape != (n,) or not pset.all():
        return None
    if vals[-1] != 0 or sorted(vals[:-1].tolist()) != list(range(1, n)):
        return None
    t, cur = 0, 0
    for j in vals.tolist():
        t = max(t + int(dist[cur][j]), int(twe[j]))
        if t > twl[j]:
            return None
        cur = j
    return -t


def control(inst: dict, width: int = 4):
    """The control put in the program's place: a restricted DP, which keeps
    the `width` labels (visited set, last node) of earliest arrival after
    each move, and reports its shortest tour as the proved optimum: a
    search that skips its proof.  Returns (objective, vals, pset)."""
    dist, twe, twl = inst["dist"], inst["twe"], inst["twl"]
    n = len(dist)
    layer = {(1, 0): (0, (0,))}
    for _ in range(n - 1):
        nxt = {}
        for (mask, last), (t, tour) in layer.items():
            for j in range(1, n):
                a = max(t + int(dist[last][j]), int(twe[j]))
                if mask >> j & 1 or a > twl[j]:
                    continue
                key = (mask | 1 << j, j)
                if key not in nxt or a < nxt[key][0]:
                    nxt[key] = (a, tour + (j,))
        layer = dict(sorted(nxt.items(), key=lambda kv: kv[1][0])[:width])
    ends = [(max(t + int(dist[last][0]), int(twe[0])), tour)
            for (_, last), (t, tour) in layer.items()]
    ends = [e for e in ends if e[0] <= twl[0]]
    if not ends:
        return None, np.zeros(n, np.int64), np.zeros(n, bool)
    end, tour = min(ends)
    return -end, np.asarray(tour[1:] + (0,), np.int64), np.ones(n, bool)
