"""TSP with time windows, batch-first: counterpart of
`ddo_tpu/models/tsptw.py`.

Reference model: ddo/examples/tsptw/{state,model,relax,dominance,
heuristics,instance}.rs
  * state (state.rs:34-56): the position as a set of nodes (a singleton
    for an exact node, a pool after a merge), the elapsed time as an
    interval [e_lo, e_hi], and the must/maybe visit sets, all int32 words
    (`ops/bitset.py`);
  * domain (model.rs for_each_in_domain): every must-node while all of
    them are still reachable (else the state dies), plus the reachable
    maybe-nodes; at depth n-1 only the depot;
  * transition and cost (model.rs:62-154): interval arrival clamped to the
    window, cost = -(travel + waiting); distances are scaled x10000 with
    float32 truncation like the reference parser (instance.rs:53-66);
  * merge (relax.rs RelaxHelper): position union, elapsed hull, must
    intersection, maybe = (union must | union maybe) - intersection;
  * rough bound (relax.rs fast_upper_bound): the cheapest incoming edges
    of the nodes still to visit, with reachability checks;
  * dominance (dominance.rs): key = (position, must), by value alone (no
    coordinate columns);
  * TsptwWidth (heuristics.rs): nb_vars * (depth + 1) * factor.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.heuristics import WidthHeuristic
from ddo_tpu_torch.core.problem import (Dominance, Problem, Relaxation, StateRanking,
                                        depth_select)
from ddo_tpu_torch.ops import bitset as bs
from ddo_tpu_torch.utils.num import INF, NEG_INF

I32 = torch.int32
SCALE = np.float32(10000.0)


def singletons_np(n: int) -> np.ndarray:
    """{j} for every node j: int32 words [n, L]."""
    out = np.zeros((n, bs.nb_lanes(n)), np.uint32)
    for j in range(n):
        out[j, j // 32] = np.uint32(1) << np.uint32(j % 32)
    return out.view(np.int32)


def merge_sets(states, mask, pos_leaf):
    """The merge of TSPTW and SOP (relax.rs RelaxHelper) over the rows
    `mask` [B, C] of `states` [B, C, ...]: the union of `pos_leaf`, the
    intersection of the must sets, and maybe = (all must | all maybe)
    minus that intersection."""
    m = mask[:, :, None]
    agree = bs.and_reduce(torch.where(m, states["must"], -1), dim=1)
    all_must = bs.or_reduce(torch.where(m, states["must"], 0), dim=1)
    all_maybe = bs.or_reduce(torch.where(m, states["maybe"], 0), dim=1)
    return {pos_leaf: bs.or_reduce(torch.where(m, states[pos_leaf], 0), dim=1),
            "must": agree, "maybe": (all_maybe | all_must) & ~agree}


class Tsptw(Problem):
    name = "tsptw"

    def __init__(self, distances, tw_earliest, tw_latest):
        self.dist = np.asarray(distances, np.int64)
        n = self.nb_variables = int(self.dist.shape[0])
        self.domain_size = n
        self.twe = np.asarray(tw_earliest, np.int64)
        self.twl = np.asarray(tw_latest, np.int64)
        # cheapest incoming edge per node (relax.rs compute_cheapest_edges)
        dd = self.dist.copy()
        np.fill_diagonal(dd, 1 << 40)
        self.cheapest = dd.min(axis=0)
        self._data = {}

    @classmethod
    def from_numpy(cls, dist, twe, twl) -> "Tsptw":
        """The port's model of the instance a ddo_tpu `Tsptw` holds
        (`pb.dist`, `pb.twe`, `pb.twl`)."""
        return cls(dist, twe, twl)

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            single = singletons_np(self.nb_variables)
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=I32, device=device)
            self._data[device] = dict(
                dist=t(self.dist), twe=t(self.twe), twl=t(self.twl),
                cheapest=t(self.cheapest), single=t(single), without=t(~single),
            )
        return self._data[device]

    def initial_state(self):
        n = self.nb_variables
        single = singletons_np(n)
        return {"pos": single[0], "e_lo": np.asarray(0, np.int32),
                "e_hi": np.asarray(0, np.int32), "must": bs.full_set_np(n) & ~single[0],
                "maybe": np.zeros(bs.nb_lanes(n), np.int32)}

    def step(self, data, states, var, depth):
        n = self.nb_variables
        dist = data["dist"]
        pos_bits = bs.to_bits(states["pos"], n)  # [B, n]
        must_bits = bs.to_bits(states["must"], n)
        maybe_bits = bs.to_bits(states["maybe"], n)
        e_lo, e_hi = states["e_lo"][:, None], states["e_hi"][:, None]

        # min / max distance from the position pool to every node j
        # (model.rs min_distance_to / max_distance_to): [B, n]
        dmin = torch.where(pos_bits[:, :, None], dist, INF).amin(dim=1)
        dmax = torch.where(pos_bits[:, :, None], dist, NEG_INF).amax(dim=1)
        # reachability: e_lo + min-dist <= latest (model.rs can_move_to)
        reach = e_lo + dmin <= data["twl"]
        # at depth n - 1 only the depot
        all_must_ok = torch.where(must_bits, reach, True).all(dim=1, keepdim=True)
        valid = depth_select(depth == n - 1,
                             (torch.arange(n, device=reach.device) == 0) & reach[:, :1],
                             all_must_ok & (must_bits | (maybe_bits & reach)))

        amin, amax = e_lo + dmin, e_hi + dmax
        twe, twl = data["twe"], data["twl"]
        ne_lo = torch.maximum(amin, twe)
        ne_hi = torch.where(amin == amax, ne_lo, torch.minimum(amax, twl))
        waiting = torch.clamp(twe - amin, min=0)
        cost = -(dmin + waiting)

        without = data["without"]  # [n, L]
        nstate = {"pos": data["single"].expand((valid.shape[0],) + tuple(without.shape)),
                  "e_lo": ne_lo, "e_hi": ne_hi,
                  "must": states["must"][:, None] & without,
                  "maybe": states["maybe"][:, None] & without}
        dval = torch.arange(n, dtype=I32, device=valid.device).expand_as(valid)
        return nstate, cost, dval, valid

    def pack(self, states):
        return torch.cat([states["pos"], states["e_lo"][:, None], states["e_hi"][:, None],
                          states["must"], states["maybe"]], dim=1)

    def unpack(self, cols):
        L = bs.nb_lanes(self.nb_variables)
        cols = np.asarray(cols, np.int32)
        return {"pos": cols[:L], "e_lo": np.asarray(cols[L]), "e_hi": np.asarray(cols[L + 1]),
                "must": cols[L + 2 : 2 * L + 2], "maybe": cols[2 * L + 2 : 3 * L + 2]}


class TsptwRelax(Relaxation):
    def __init__(self, problem: Tsptw):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """relax.rs RelaxHelper: position union, elapsed hull, must
        intersection, maybe = (all must | all maybe) - agreed."""
        out = merge_sets(states, mask, "pos")
        out["e_lo"] = torch.where(mask, states["e_lo"], INF).amin(dim=1)
        out["e_hi"] = torch.where(mask, states["e_hi"], -INF).amax(dim=1)
        return out

    def rub(self, data, states, depth):
        """relax.rs fast_upper_bound."""
        n = self.problem.nb_variables
        pos_bits = bs.to_bits(states["pos"], n)
        must_bits = bs.to_bits(states["must"], n)
        maybe_bits = bs.to_bits(states["maybe"], n)
        e_lo = states["e_lo"]
        cheapest, twl = data["cheapest"], data["twl"]
        to_depot = data["dist"][:, 0]

        nb_must = must_bits.sum(dim=1, dtype=I32)
        complete_tour = n - depth - nb_must
        mandatory = torch.where(must_bits, cheapest, 0).sum(dim=1, dtype=I32)
        back = torch.where(must_bits | maybe_bits, to_depot, INF).amin(dim=1)
        late = e_lo[:, None] + cheapest > twl
        must_violation = (must_bits & late).any(dim=1)

        has_maybe = maybe_bits.any(dim=1)
        violations = (maybe_bits & late).sum(dim=1, dtype=I32)
        nb_maybe = maybe_bits.sum(dim=1, dtype=I32)
        maybe_short = has_maybe & (nb_maybe - violations < complete_tour)
        # the sum of the `complete_tour` cheapest maybe edges
        mc = torch.sort(torch.where(maybe_bits, cheapest, INF), dim=1).values
        csum = torch.cumsum(torch.where(mc >= INF, 0, mc), dim=1, dtype=I32)
        csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)
        take = torch.clamp(torch.minimum(complete_tour, nb_maybe), 0, n)
        mandatory = mandatory + torch.where(
            has_maybe, csum.gather(1, take[:, None].long())[:, 0], 0)

        pos_back = torch.where(pos_bits, to_depot, INF).amin(dim=1)
        back = torch.where(mandatory == 0, torch.minimum(back, pos_back), back)
        total = mandatory + back
        feasible = (e_lo + total <= twl[0]) & ~must_violation & ~maybe_short
        return torch.where(feasible, -total, NEG_INF).to(I32)


class TsptwRanking(StateRanking):
    """heuristics.rs TsptwRanking compares depth: constant in a layer."""

    def score(self, data, states):
        return torch.zeros((states["e_lo"].shape[0], 1), dtype=I32,
                           device=states["e_lo"].device)

    def score_host(self, state):
        return 0


class TsptwDominance(Dominance):
    """dominance.rs: key = (position, must), compared by value alone."""

    use_value = True

    def key_cols(self, states):
        return torch.cat([states["pos"], states["must"]], dim=1)

    def coord_cols(self, states):
        return torch.zeros((states["pos"].shape[0], 0), dtype=I32,
                           device=states["pos"].device)


class TsptwWidth(WidthHeuristic):
    """heuristics.rs: nb_vars * (depth + 1) * factor."""

    def __init__(self, nb_vars: int, factor: int = 1):
        self.nb_vars = nb_vars
        self.factor = factor

    def max_width(self, sub):
        return self.nb_vars * (int(sub.depth) + 1) * self.factor


def _scaled(x):
    """instance.rs:53-66: a float32 value times 10000, truncated."""
    return int(np.float32(x) * SCALE)


def read_instance(path: str) -> Tsptw:
    """instance.rs parser: n, n distance-matrix rows, n time windows;
    floats scaled x10000 with float32 truncation."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    n = int(lines[0].split()[0])
    dist = np.zeros((n, n), np.int64)
    for i in range(n):
        dist[i] = [_scaled(v) for v in lines[1 + i].split()]
    twe = np.zeros(n, np.int64)
    twl = np.zeros(n, np.int64)
    for i in range(n):
        parts = lines[1 + n + i].split()
        twe[i], twl[i] = _scaled(parts[0]), _scaled(parts[1])
    return Tsptw(dist, twe, twl)


def generate_random(n: int, seed: int, window: float = 40.0):
    """A seeded instance of n nodes (node 0 the depot) in the shape of
    Langevin's and Dumas's sets: points uniform in a 50 x 50 square, Euclidean distances in float32 scaled x10000 as
    `read_instance` scales them, and for each customer a window of width
    `window` (unscaled) placed at random around its arrival time on a
    random tour, so that this tour, and so the instance, is feasible.  The
    depot's window closes `window` after the tour's return."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 50.0, (n, 2)).astype(np.float32)
    d = np.sqrt(((xy[:, None] - xy[None, :]) ** 2).sum(-1)).astype(np.float32)
    dist = (d * SCALE).astype(np.int64)  # float32 product, truncated
    tour = [0] + list(rng.permutation(np.arange(1, n))) + [0]
    w = _scaled(window)
    twe, twl = np.zeros(n, np.int64), np.zeros(n, np.int64)
    t = 0
    for a, b in zip(tour[:-2], tour[1:-1]):
        t += int(dist[a, b])
        lo = max(0, t - int(rng.integers(0, w + 1)))
        twe[b], twl[b] = lo, lo + w
    t += int(dist[tour[-2], 0])
    twl[0] = t + w
    return Tsptw(dist, twe, twl)
