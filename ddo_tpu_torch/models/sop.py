"""Sequential ordering problem, batch-first: counterpart of
`ddo_tpu/models/sop.py`.

Reference model: ddo/examples/sop/{state,model,relax,heuristics,
io_utils}.rs
  * state = the previous-job pool and the must/maybe schedule sets, int32
    words (state.rs);
  * dist[i][j] == -1 encodes a precedence: j must precede i
    (io_utils.rs read_instance);
  * domain: schedulable jobs whose predecessors are all done (model.rs
    can_schedule); the last job at the last rank;
  * cost = -min over the previous pool of dist[prev][j] (model.rs
    min_distance_to); a forbidden distance is INF, so its cost is
    NEG_INF;
  * merge like TSPTW's (relax.rs RelaxHelper);
  * rough bound: a cheapest-incoming-edge matching with the four-case
    take count (relax.rs fast_upper_bound);
  * SopWidth (heuristics.rs): nb_vars * (depth + 1) * factor.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking, depth_select
from ddo_tpu_torch.models.tsptw import TsptwWidth, merge_sets, singletons_np
from ddo_tpu_torch.ops import bitset as bs
from ddo_tpu_torch.utils import trace
from ddo_tpu_torch.utils.num import INF, NEG_INF, sat_add

I32 = torch.int32


class Sop(Problem):
    name = "sop"

    def __init__(self, distances):
        self.dist = np.asarray(distances, np.int64)
        self.nb_jobs = int(self.dist.shape[0])
        self.nb_variables = self.nb_jobs - 1
        self.domain_size = self.nb_jobs
        # pred[i][j]: j precedes i
        self.pred = self.dist == -1
        dist_eff = np.where(self.pred, 1 << 40, self.dist)
        np.fill_diagonal(dist_eff, 1 << 40)
        self.dist_eff = np.minimum(dist_eff, INF)  # INF = forbidden
        self._data = {}

    @classmethod
    def from_numpy(cls, dist) -> "Sop":
        """The port's model of the instance a ddo_tpu `Sop` holds
        (`pb.dist`, the matrix with its -1 precedences)."""
        return cls(dist)

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            single = singletons_np(self.nb_jobs)
            t = lambda a: torch.as_tensor(a, dtype=I32, device=device)
            self._data[device] = dict(
                dist=t(self.dist_eff),
                # predecessor counts are a float32 product: exact below 2^24
                pred_t=torch.as_tensor(self.pred.T, dtype=torch.float32, device=device),
                single=t(single), without=t(~single))
        return self._data[device]

    def initial_state(self):
        n = self.nb_jobs
        first = singletons_np(n)[0]
        return {"prev": first, "must": bs.full_set_np(n) & ~first,
                "maybe": np.zeros(bs.nb_lanes(n), np.int32)}

    def step(self, data, states, var, depth):
        n = self.nb_jobs
        prev_bits = bs.to_bits(states["prev"], n)  # [B, n]
        rem = bs.to_bits(states["must"] | states["maybe"], n)
        # can_schedule (model.rs): no predecessor of j still to schedule
        sched_ok = (rem.to(torch.float32) @ data["pred_t"]) == 0  # [B, n]
        valid = depth_select(depth == self.nb_variables - 1,
                             (torch.arange(n, device=rem.device) == n - 1).expand_as(rem),
                             rem & sched_ok)
        dmin = torch.where(prev_bits[:, :, None], data["dist"], INF).amin(dim=1)
        without = data["without"]
        nstate = {"prev": data["single"].expand((rem.shape[0],) + tuple(without.shape)),
                  "must": states["must"][:, None] & without,
                  "maybe": states["maybe"][:, None] & without}
        dval = torch.arange(n, dtype=I32, device=rem.device).expand_as(valid)
        return nstate, -dmin, dval, valid

    def pack(self, states):
        return torch.cat([states["prev"], states["must"], states["maybe"]], dim=1)

    def unpack(self, cols):
        L = bs.nb_lanes(self.nb_jobs)
        cols = np.asarray(cols, np.int32)
        return {"prev": cols[:L], "must": cols[L : 2 * L], "maybe": cols[2 * L : 3 * L]}


class SopRelax(Relaxation):
    def __init__(self, problem: Sop):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        return merge_sets(states, mask, "prev")

    def rub(self, data, states, depth):
        """relax.rs fast_upper_bound: the four-case cheapest-edge bound."""
        pb = self.problem
        n = pb.nb_jobs
        prev_bits = bs.to_bits(states["prev"], n)
        must_bits = bs.to_bits(states["must"], n)
        maybe_bits = bs.to_bits(states["maybe"], n)
        rem = must_bits | maybe_bits
        D = data["dist"]  # INF == forbidden

        ct = pb.nb_variables - depth  # complete_tour
        n_must = must_bits.sum(dim=1, dtype=I32)
        # cheapest edge into i from any remaining j (INF when none)
        into = torch.where(rem[:, :, None], D, INF).amin(dim=1)  # [B, n]
        to_must = torch.where(must_bits & (into < INF), into, INF)
        # distance from the previous pool to each candidate i
        from_pos = torch.where(prev_bits[:, :, None], D, INF).amin(dim=1)
        use_maybe = (n_must < ct)[:, None]
        to_maybe = torch.where(use_maybe & maybe_bits & (into < INF), into, INF)
        dfp = torch.where(must_bits | (use_maybe & maybe_bits), from_pos, INF).amin(dim=1)

        def prefix(x):
            """Ascending x and its prefix sums of the real (< INF) entries,
            [B, n] and [B, n+1]."""
            x = torch.sort(x, dim=1).values
            c = torch.cumsum(torch.where(x < INF, x, 0), dim=1, dtype=I32)
            return x, torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)

        def pref(csum, k):
            if not torch.is_tensor(k):  # a host int crosses to the device
                k = trace.wait(torch.as_tensor, k, device=csum.device)
            k = k.expand(csum.shape[0])
            return csum.gather(1, torch.clamp(k, 0, n)[:, None].long())[:, 0]

        tm, ctm = prefix(to_must)
        tb, ctb = prefix(to_maybe)
        len_tm = (tm < INF).sum(dim=1, dtype=I32)
        tm_max = tm.gather(1, torch.clamp(len_tm - 1, 0, n - 1)[:, None].long())[:, 0]
        tb_min = tb[:, 0]

        case1 = pref(ctm, ct - 1)  # n_must >= ct
        case2 = pref(ctb, ct - 1)  # to_must empty
        case3 = pref(ctm, n) + pref(ctb, ct - 1 - len_tm)
        case4 = pref(ctm, len_tm - 1) + pref(ctb, ct - len_tm)
        tail = torch.where(n_must >= ct, case1,
                           torch.where(len_tm == 0, case2,
                                       torch.where(tm_max <= tb_min, case3, case4)))
        total = sat_add(dfp, tail)
        return torch.where(total >= INF, NEG_INF, -total).to(I32)


class SopRanking(StateRanking):
    """heuristics.rs SopRanking compares depth: constant in a layer."""

    def score(self, data, states):
        return torch.zeros((states["prev"].shape[0], 1), dtype=I32,
                           device=states["prev"].device)

    def score_host(self, state):
        return 0


class SopWidth(TsptwWidth):
    """heuristics.rs: nb_vars * (depth + 1) * factor."""


def read_instance(path: str) -> Sop:
    """TSPLIB .sop parser (io_utils.rs): EDGE_WEIGHT_SECTION, n, matrix."""
    rows = []
    n = None
    in_section = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if "EDGE_WEIGHT_SECTION" in line:
                in_section = True
                continue
            if not in_section or not line:
                continue
            if n is None:
                n = int(line.split()[0])
                continue
            rows.extend(int(x) for x in line.split())
            if len(rows) >= n * n:
                break
    return Sop(np.asarray(rows[: n * n], np.int64).reshape(n, n))


def generate_random(n: int, seed: int, p_prec: float = 0.1) -> Sop:
    """A seeded instance of n jobs in the TSPLIB .sop layout: job 0 first
    and job n-1 last (dist[i][0] = dist[n-1][i] = -1), random distances in
    [1, 100), and each pair i < j of the other jobs a precedence (i before
    j: dist[j][i] = -1) with probability `p_prec`, so the precedences are
    acyclic."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(1, 100, (n, n)).astype(np.int64)
    np.fill_diagonal(dist, 0)
    iu = np.triu_indices(n, 1)
    prec = rng.random(len(iu[0])) < p_prec
    dist[iu[1][prec], iu[0][prec]] = -1
    dist[1:, 0] = -1
    dist[n - 1, : n - 1] = -1
    return Sop(dist)
