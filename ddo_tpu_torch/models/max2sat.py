"""Weighted MAX2SAT, batch-first: counterpart of `ddo_tpu/models/max2sat.py`.

Reference model: ddo/examples/max2sat/{model,relax,data}.rs
  * state = per-variable signed marginal benefits (model.rs:59-62), a
    dense int32[n] vector;
  * branching order: variables sorted by increasing sum of clause weights,
    branched from the largest down (model.rs:150-152, 330-340);
  * transition/cost (model.rs:275-328) vectorized over the remaining-var
    mask with precomputed [n, n] literal-pair weight matrices;
  * merge: per-variable same-sign min-abs benefit (relax.rs:47-77);
  * relax: cost offset by the benefit lost in the merge (relax.rs:78-84);
  * rough bound: marginal benefit + precomputed estimates
    (model.rs:240-250, precomputed with numpy, model.rs:183-238).
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking, depth_row

I32 = torch.int32
T, F = 1, -1
_BIG = 1 << 30


def clause_tables(nb_vars: int, clauses):
    """The dense tables of a clause dict {(a, b): weight} (1-based signed
    literals, a <= b; the parsed `Weighed2Sat`, data.rs:33-37): a dict of
    int64 numpy arrays and the constant `initial`."""
    n = int(nb_vars)
    wtt, wtf, wff = (np.zeros((n, n), np.int64) for _ in range(3))
    unit_t, unit_f, taut, sum_w = (np.zeros(n, np.int64) for _ in range(4))
    initial = 0
    for (a, b), w in clauses.items():
        ia, ib = abs(a) - 1, abs(b) - 1
        sum_w[ia] += w
        if a != b:  # non-unit (model.rs:140-143)
            sum_w[ib] += w
        if a == -b:  # tautology
            initial += w
            taut[ia] = w
        elif a == b:  # unit clause
            if a > 0:
                unit_t[ia] = w
            else:
                unit_f[ia] = w
        else:
            pa, pb = a > 0, b > 0
            # wtf[k, l] == weight(t(k), f(l)); wft is its transpose
            if pa and pb:
                wtt[ia, ib] = wtt[ib, ia] = w
            elif not pa and not pb:
                wff[ia, ib] = wff[ib, ia] = w
            elif pa and not pb:  # clause (a v -b): t(a) with f(b)
                wtf[ia, ib] = w
            else:  # clause (-a v b): f(a) with t(b) == t(b) with f(a)
                wtf[ib, ia] = w

    # variable ordering by increasing sum of clause weights
    order_asc = np.argsort(sum_w, kind="stable")
    rank_pos = np.zeros(n, np.int64)
    rank_pos[order_asc] = np.arange(n)
    wft = wtf.T.copy()  # wft[k, l] = weight(f(k), t(l))

    # estimates (model.rs:204-238) and nk (model.rs:190-198) over the
    # ascending order
    ix = np.ix_(order_asc, order_asc)
    A, Btf, Bft, Cff = wtt[ix], wtf[ix], wft[ix], wff[ix]
    pairmax = np.maximum(np.maximum(A + Btf + Bft, A + Btf + Cff),
                         np.maximum(A + Bft + Cff, Btf + Bft + Cff))
    iu = np.triu_indices(n, 1)
    pair_contrib = np.zeros(n, np.int64)
    np.add.at(pair_contrib, iu[0], pairmax[iu])
    tail = pair_contrib + taut[order_asc] + np.maximum(unit_t[order_asc], unit_f[order_asc])
    estimates = np.concatenate([np.cumsum(tail[::-1])[::-1], [0]])[:n]
    nk = np.concatenate([[0], np.cumsum(taut[order_asc])])[:n]
    return dict(wtt=wtt, wtf=wtf, wft=wft, wff=wff, unit_t=unit_t, unit_f=unit_f,
                rank_pos=rank_pos, var_order=order_asc[::-1].copy(),
                estimates=estimates, nk=nk, initial=np.asarray(int(initial)))


class Max2Sat(Problem):
    name = "max2sat"

    def __init__(self, nb_vars: int, clauses):
        self.nb_variables = int(nb_vars)
        self.domain_size = 2
        self.tables = clause_tables(nb_vars, clauses)
        self.initial = int(self.tables["initial"])
        self._data = {}

    @classmethod
    def from_numpy(cls, tables) -> "Max2Sat":
        """The port's model of the instance a ddo_tpu `Max2Sat` holds:
        `tables` is its `data` dict as numpy arrays (wtt, wtf, wft, wff,
        unit_t, unit_f, rank_pos, var_order, estimates, nk, initial)."""
        pb = cls(len(tables["unit_t"]), {})
        pb.tables = {k: np.asarray(v, np.int64) for k, v in tables.items()}
        pb.initial = int(pb.tables["initial"])
        return pb

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            self._data[device] = {
                k: torch.as_tensor(v, dtype=I32, device=device)
                for k, v in self.tables.items()}
        return self._data[device]

    def initial_state(self):
        return {"benef": np.zeros(self.nb_variables, np.int32)}

    def initial_value(self) -> int:
        return self.initial

    def var_order(self):
        return self.tables["var_order"].astype(np.int32)

    def step(self, data, states, var, depth):
        n = self.nb_variables
        s = states["benef"]  # [B, n]
        sk = s.gather(1, var[:, None])[:, 0]
        # remaining (unbranched-after-k) vars: ascending-order rank below
        # n - depth - 1 (model.rs:173-181)
        rem = data["rank_pos"] < (n - depth - 1)  # [n]
        wtt_k, wtf_k = data["wtt"][var], data["wtf"][var]  # [B, n]
        wft_k, wff_k = data["wft"][var], data["wff"][var]
        pos = lambda x: torch.clamp(x, min=0)

        # transition (model.rs:275-292): slot 0 sets k true, slot 1 false
        shift = torch.stack([wft_k - wff_k, wtt_k - wtf_k], dim=1)  # [B, D, n]
        ns = torch.where(rem, s[:, None] + shift, s[:, None])
        ns = ns.scatter(2, var[:, None, None].expand(-1, 2, 1), 0)

        # transition cost (model.rs:294-328)
        sat_t = wtt_k + wtf_k + torch.minimum(pos(s) + wft_k, pos(-s) + wff_k)
        sat_f = wff_k + wft_k + torch.minimum(pos(s) + wtt_k, pos(-s) + wtf_k)
        sum_t = torch.where(rem, sat_t, 0).sum(dim=1) + data["unit_t"][var] + pos(sk)
        sum_f = torch.where(rem, sat_f, 0).sum(dim=1) + data["unit_f"][var] + pos(-sk)
        cost = torch.stack([sum_t, sum_f], dim=1).to(I32)
        dval = torch.where(torch.arange(2, device=s.device) == 0, T, F).to(I32).expand_as(cost)
        return {"benef": ns}, cost, dval, torch.ones_like(cost, dtype=torch.bool)

    def pack(self, states):
        return states["benef"]


def _lost_benefit(dst, merged):
    return (dst["benef"].abs() - merged["benef"].abs()).sum(dim=1)


class Max2SatRelax(Relaxation):
    def __init__(self, problem: Max2Sat):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """Per-variable same-sign min-abs merge (relax.rs:47-77)."""
        s = states["benef"]  # [B, C, n]
        m = mask[:, :, None]
        abs_min = torch.where(m, s.abs(), _BIG).amin(dim=1)
        has_pos = (m & (s > 0)).any(dim=1)
        has_neg = (m & (s < 0)).any(dim=1)
        sign = has_pos.to(I32) - has_neg.to(I32)  # 0 when mixed or all zero
        benef = torch.where(has_pos & has_neg, 0, sign * torch.clamp(abs_min, max=_BIG - 1))
        return {"benef": torch.where(mask.any(dim=1, keepdim=True), benef, 0).to(I32)}

    def relax_cost(self, data, src, dst, merged, dval, cost, var):
        """relax.rs:78-84: recover the benefit lost to the merge."""
        return (cost + _lost_benefit(dst, merged)).to(I32)

    def rub(self, data, states, depth):
        """model.rs:240-250."""
        marginal = states["benef"].abs().sum(dim=1)
        return (marginal + depth_row(data["estimates"], depth) - data["initial"]
                + depth_row(data["nk"], depth)).to(I32)


class Max2SatRanking(StateRanking):
    """Order by total absolute benefit (model.rs:40-54)."""

    def score(self, data, states):
        return states["benef"].abs().sum(dim=1, keepdim=True).to(I32)

    def score_host(self, state):
        return int(np.abs(np.asarray(state["benef"])).sum())


def read_instance(path: str) -> Max2Sat:
    """wcnf parser (data.rs:40-111): `p wcnf n m` then `w x y 0` / `w x 0`."""
    clauses = {}
    nb_vars = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("c"):
                continue
            parts = line.split()
            if parts[0] == "p":
                nb_vars = int(parts[2])
                continue
            # clauses may carry trailing inline comments: read ints up to
            # the 0 terminator only
            nums = []
            for p in parts:
                try:
                    v = int(p)
                except ValueError:
                    break
                nums.append(v)
                if len(nums) > 1 and v == 0:
                    break
            if len(nums) < 2 or nums[-1] != 0:
                continue
            lits = [x for x in nums[1:] if x != 0]
            if len(lits) == 1:
                a = b = lits[0]
            elif len(lits) == 2:
                a, b = min(lits), max(lits)
            else:
                continue
            clauses[(a, b)] = nums[0]
    return Max2Sat(nb_vars, clauses)


def generate_random(n: int, nb_clauses: int, seed: int, max_weight: int = 9):
    """A seeded random weighted 2-SAT instance: `(Max2Sat, clauses)`, each
    clause two signed literals over distinct variables (or one literal
    twice: a unit clause, about one in ten) with a weight in
    [1, max_weight]."""
    rng = np.random.default_rng(seed)
    clauses = {}
    for _ in range(nb_clauses):
        x, y = (int(v) for v in rng.choice(n, 2, replace=False) + 1)
        a = x if rng.random() < 0.5 else -x
        b = a if rng.random() < 0.1 else (y if rng.random() < 0.5 else -y)
        clauses[(min(a, b), max(a, b))] = int(rng.integers(1, max_weight + 1))
    return Max2Sat(n, clauses), clauses
