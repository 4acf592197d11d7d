"""Maximum cut (MCP), batch-first: counterpart of `ddo_tpu/models/mcp.py`.

Reference model: ddo/examples/mcp/{model,relax,graph}.rs
  * state = per-vertex signed marginal benefits (model.rs McpState);
  * natural (static) variable order, symmetry broken by forcing the first
    vertex to side S (model.rs for_each_in_domain);
  * transition zeroes entries below the branched vertex and shifts the
    rest by +/- the adjacency row (model.rs transition);
  * costs: sign-disagreement min terms (model.rs branch_on_s/t);
  * merge: per-vertex sign partition: all-positive -> min, all-negative
    -> -min|.|, mixed -> 0 (relax.rs merge_substates);
  * relax: cost + sum(|dst| - |merged|) (relax.rs relax);
  * rough bound: remaining |benefits| + positive-edge estimate
    (relax.rs precompute_estimate) adjusted by the vr/nk terms.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking
from ddo_tpu_torch.utils import trace

I32 = torch.int32
S, T = 1, -1
_BIG = 1 << 30


class Mcp(Problem):
    name = "mcp"

    def __init__(self, nb_vars: int, edges):
        n = int(nb_vars)
        w = np.zeros((n, n), np.int64)
        for a, b, wt in edges:
            w[a, b] = wt
            w[b, a] = wt
        self._init_from_matrix(w)

    def _init_from_matrix(self, w):
        n = self.nb_variables = w.shape[0]
        self.domain_size = 2
        self.w = w
        iu = np.triu_indices(n, 1)
        upper = w[iu]
        self.initial = int(upper[upper < 0].sum())
        # estimates[d] = sum of positive weights among vertices >= d
        # (relax.rs precompute_estimate); nk[d] = sum of negative weights
        # within vertices < d (relax.rs precompute_nk)
        d = np.arange(n + 1)[:, None]
        self.estimates = np.where(iu[0] >= d, np.maximum(upper, 0), 0).sum(axis=1)
        self.nk = np.where(iu[1] < d, np.minimum(upper, 0), 0).sum(axis=1)
        self._data = {}

    @classmethod
    def from_numpy(cls, w) -> "Mcp":
        """The port's model of the instance a ddo_tpu `Mcp` holds: `w` is
        its symmetric weight matrix `pb.w`."""
        pb = cls.__new__(cls)
        pb._init_from_matrix(np.asarray(w, np.int64))
        return pb

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=I32, device=device)
            self._data[device] = dict(w=t(self.w), estimates=t(self.estimates),
                                      nk=t(self.nk), vr=t(self.initial))
        return self._data[device]

    def initial_state(self):
        return {"benef": np.zeros(self.nb_variables, np.int32)}

    def initial_value(self) -> int:
        return self.initial

    def step(self, data, states, var, depth):
        s = states["benef"]  # [B, n]
        B, n = s.shape
        dval = trace.wait(torch.tensor, [S, T], dtype=I32, device=s.device)  # [D]
        wrow = data["w"][var]  # [B, n]
        rem = torch.arange(n, device=s.device) >= var[:, None]  # [B, n]
        ns = torch.where(rem[:, None], s[:, None] + dval[:, None] * wrow[:, None], 0)

        # cost terms (model.rs branch_on_s / branch_on_t); the diagonal
        # contributes 0 since w[x, x] == 0
        prod = s * wrow
        mn = torch.minimum(s.abs(), wrow.abs())
        sk = s.gather(1, var[:, None])[:, 0]
        cost_s = torch.clamp(-sk, min=0) + torch.where(rem & (prod <= 0), mn, 0).sum(dim=1)
        cost_t = torch.clamp(sk, min=0) + torch.where(rem & (prod >= 0), mn, 0).sum(dim=1)
        cost = torch.stack([cost_s, cost_t], dim=1).to(I32)
        valid = torch.ones((B, 2), dtype=torch.bool, device=s.device)
        if depth == 0:  # the root branches only on S (symmetry), at no cost
            cost = torch.zeros_like(cost)
            valid[:, 1] = False
        return {"benef": ns.to(I32)}, cost, dval.expand(B, 2), valid

    def pack(self, states):
        return states["benef"]


class McpRelax(Relaxation):
    def __init__(self, problem: Mcp):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """Sign-partitioned merge (relax.rs merge_substates)."""
        s = states["benef"]  # [B, C, n]
        m = mask[:, :, None]
        has_pos = (m & (s > 0)).any(dim=1)
        has_neg = (m & (s < 0)).any(dim=1)
        min_sub = torch.where(m, s, _BIG).amin(dim=1)
        min_abs = torch.where(m, s.abs(), _BIG).amin(dim=1)
        out = torch.where(has_pos & ~has_neg, min_sub,
                          torch.where(has_neg & ~has_pos, -min_abs, 0))
        return {"benef": torch.where(mask.any(dim=1, keepdim=True), out, 0).to(I32)}

    def relax_cost(self, data, src, dst, merged, dval, cost, var):
        lost = (dst["benef"].abs() - merged["benef"].abs()).sum(dim=1)
        return (cost + lost).to(I32)

    def rub(self, data, states, depth):
        s = states["benef"]
        rem = torch.arange(s.shape[1], device=s.device) >= depth
        marginal = torch.where(rem, s.abs(), 0).sum(dim=1)
        return (marginal + data["estimates"][depth] - data["vr"]
                + data["nk"][depth]).to(I32)


class McpRanking(StateRanking):
    """Total absolute benefit (model.rs McpRanking)."""

    def score(self, data, states):
        return states["benef"].abs().sum(dim=1, keepdim=True).to(I32)

    def score_host(self, state):
        return int(np.abs(np.asarray(state["benef"])).sum())


def read_instance(path: str) -> Mcp:
    """graph.rs from_lines: `n m` header then `src dst weight` (1-based)."""
    nb = 0
    edges = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("c"):
                continue
            parts = line.split()
            if len(parts) == 2:
                nb = int(parts[0])
            elif len(parts) == 3:
                edges.append((int(parts[0]) - 1, int(parts[1]) - 1, int(parts[2])))
    return Mcp(nb, edges)


def generate_random(n: int, p: float, seed: int, max_abs_weight: int = 9):
    """A seeded random weighted graph: `(Mcp, edges)`, every vertex pair an
    edge with probability `p` and a non-zero weight in
    [-max_abs_weight, max_abs_weight]."""
    rng = np.random.default_rng(seed)
    edges = []
    for a in range(n):
        for b in range(a + 1, n):
            if rng.random() < p:
                wt = int(rng.integers(1, max_abs_weight + 1))
                edges.append((a, b, wt if rng.random() < 0.7 else -wt))
    return Mcp(n, edges), edges
