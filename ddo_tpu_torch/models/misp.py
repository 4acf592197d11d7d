"""Maximum (weighted) independent set, batch-first: counterpart of
`ddo_tpu/models/misp.py`.

Reference model: ddo/examples/misp/main.rs
  * state = bitset of still-selectable vertices (main.rs:62-71), int32
    words (`ops/bitset.py`);
  * complement-adjacency trick (main.rs:40-45,77-85): taking vertex v
    intersects the state with ~N(v);
  * domain: {NO} always, {YES} only if v is still selectable
    (main.rs:95-102);
  * dynamic branching: the vertex occurring in the fewest states of the
    layer (min-occurrence, main.rs:109-143), one masked count per lane;
  * long arcs (main.rs:145-147): a state without the branched vertex is
    not impacted and skips the layer;
  * merge = set union (main.rs:172-178);
  * rough bound = total weight of remaining vertices (main.rs:191-193);
  * ranking = set cardinality then content (main.rs:202-209).
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking
from ddo_tpu_torch.ops import bitset as bs
from ddo_tpu_torch.utils.num import argmax_first, argmin_first

I32 = torch.int32
_I32_MAX = (1 << 31) - 1


class Misp(Problem):
    name = "misp"

    def __init__(self, nb_vars: int, edges, weight=None):
        n = self.nb_variables = int(nb_vars)
        self.domain_size = 2
        self.weight = np.asarray(weight if weight is not None else np.ones(n), np.int64)
        # complement adjacency masks (main.rs:40-45)
        comp = np.zeros((n, bs.nb_lanes(n)), np.uint32)
        comp[:] = bs.full_set_np(n).view(np.uint32)
        for a, b in edges:
            comp[a][b // 32] &= ~(np.uint32(1) << np.uint32(b % 32))
            comp[b][a // 32] &= ~(np.uint32(1) << np.uint32(a % 32))
        self.comp_adj = comp.view(np.int32)
        self._data = {}

    @classmethod
    def from_numpy(cls, weight, comp_adj) -> "Misp":
        """The port's model of the instance a ddo_tpu `Misp` holds
        (`pb.weight`, `pb.data["comp_adj"]` as a numpy uint32 [n, L]
        array): the words cross bit for bit."""
        weight = np.asarray(weight)
        pb = cls(len(weight), (), weight)
        pb.comp_adj = np.array(comp_adj, np.uint32).view(np.int32)
        return pb

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            self._data[device] = dict(
                weight=torch.as_tensor(self.weight, dtype=I32, device=device),
                comp_adj=torch.as_tensor(self.comp_adj, device=device),
            )
        return self._data[device]

    def initial_state(self):
        return {"free": bs.full_set_np(self.nb_variables)}

    def var_order(self):
        return None  # dynamic branching

    def next_variable(self, data, depth, states, mask, assigned):
        """Min-occurrence branching (main.rs:109-143): per lane, count for
        each vertex the live states that still contain it and pick the
        rarest occurring one (the first on ties).  When no vertex occurs
        (every state empty), the first unassigned variable: forced NO
        decisions down to the horizon."""
        bits = bs.to_bits(states["free"], self.nb_variables)  # [K, W, n]
        counts = (bits & mask[:, :, None]).sum(dim=1, dtype=I32)  # [K, n]
        has = counts > 0
        best = argmin_first(torch.where(has, counts, _I32_MAX))
        fallback = argmax_first((~assigned).to(I32))
        return torch.where(has.any(dim=1), best, fallback)

    def step(self, data, states, var, depth):
        free = states["free"]  # [B, L]
        in_set = bs.contains(free, var)
        removed = bs.remove(free, var)
        taken = removed & data["comp_adj"][var]
        take = torch.arange(2, device=free.device) == 1  # [D]
        valid = in_set[:, None] | ~take
        nfree = torch.stack([removed, taken], dim=1)  # [B, D, L]
        cost = torch.where(take, data["weight"][var][:, None], 0).to(I32)
        dval = take.to(I32).expand_as(valid)
        return {"free": nfree}, cost, dval, valid

    def is_impacted_by(self, data, states, var):
        """Only states that still contain the branched vertex are impacted
        (main.rs:145-147)."""
        return bs.contains(states["free"], var)

    def pack(self, states):
        return states["free"]

    def unpack(self, cols):
        return {"free": np.asarray(cols, np.int32)}


class MispRelax(Relaxation):
    def __init__(self, problem: Misp):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """Set union over the merge set (main.rs:172-178)."""
        words = torch.where(mask[:, :, None], states["free"], 0)
        return {"free": bs.or_reduce(words, dim=1)}

    def rub(self, data, states, depth):
        return bs.weight_sum(states["free"], data["weight"], self.problem.nb_variables)


class MispRanking(StateRanking):
    """main.rs:202-209: larger set first, then set content."""

    def __init__(self, problem: Misp):
        self.problem = problem

    def score(self, data, states):
        free = states["free"]
        return torch.cat([bs.count(free)[:, None], free], dim=1)

    def score_host(self, state):
        free = np.asarray(state["free"], np.int32)
        return tuple([int(sum(bin(int(x)).count("1") for x in free.view(np.uint32)))]
                     + [int(x) for x in free])


def read_instance(path: str) -> Misp:
    """DIMACS .clq parser (main.rs:258-317): `p edge n m`, `n v w` weight
    lines, `e a b` edge lines (1-indexed)."""
    nb_vars = 0
    edges = []
    weight = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("c"):
                continue
            parts = line.split()
            if parts[0] == "p":
                nb_vars = int(parts[2])
                weight = np.ones(nb_vars, np.int64)
            elif parts[0] == "n":
                weight[int(parts[1]) - 1] = int(parts[2])
            elif parts[0] == "e":
                edges.append((int(parts[1]) - 1, int(parts[2]) - 1))
    return Misp(nb_vars, edges, weight)


def generate_gnp(n: int, p: float, seed: int, max_weight: int = 1):
    """A seeded G(n, p) random graph: `(Misp, edges)` with every vertex
    pair an edge with probability `p` and weights uniform in
    [1, max_weight] (unit weights by default, like the DIMACS .clq
    graphs)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    sel = rng.random(len(iu[0])) < p
    edges = [(int(a), int(b)) for a, b in zip(iu[0][sel], iu[1][sel])]
    weight = rng.integers(1, max_weight + 1, n) if max_weight > 1 else np.ones(n, np.int64)
    return Misp(n, edges, weight), edges
