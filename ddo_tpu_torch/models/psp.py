"""Pigment sequencing (discrete lot sizing), batch-first: counterpart of
`ddo_tpu/models/psp.py`.

Reference model: ddo/examples/psp/{model,ub_utils,io_utils}.rs
  * solved backwards in time: the variable at depth d is period
    t = horizon - d - 1 (model.rs next_variable), a static order;
  * state = per item the head of its unfilled-demand chain, and the item
    produced at t+1 (`next`, IDLE = -1 when unknown) (model.rs PspState);
  * domain (model.rs for_each_in_domain): items whose head deadline is
    >= t; IDLE only while the remaining demand is < t+1; the state dies
    when the remaining demand cannot fit the remaining periods;
  * cost = -(changeover[d][next] + stocking[d] * (deadline - t));
  * merge: elementwise min heads, next = IDLE (model.rs PspRelax::merge);
  * rough bound: a greedy changeover bound over the member set,
    precomputed for all 2^n_items subsets (ub_utils.rs all_mst), plus
    ddo_tpu's earliest-deadline packing bound on the stocking cost.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking
from ddo_tpu_torch.utils.num import INF

I32 = torch.int32
IDLE = -1


def _greedy_mst_table(changeover):
    """ub_utils.rs all_mst: for every subset, the reference's greedy
    edge-cover lower bound on the changeover cost."""
    n = len(changeover)
    co = np.asarray(changeover, np.int64)
    sym = np.minimum(co, co.T)
    out = np.zeros(1 << n, np.int64)
    for mask in range(1 << n):
        members = [i for i in range(n) if mask >> i & 1]
        if len(members) <= 1:
            continue
        covered = set()
        total = 0
        for a in members:
            if a in covered:
                continue
            emin, bmin = 1 << 40, a
            for b in members:
                if b != a and sym[a][b] < emin:
                    emin, bmin = sym[a][b], b
            total += emin
            covered.add(a)
            covered.add(bmin)
        out[mask] = total
    return out


class Psp(Problem):
    name = "psp"

    def __init__(self, horizon, stocking, changeover, demands):
        self.horizon = int(horizon)
        self.n_items = len(stocking)
        self.nb_variables = self.horizon
        self.domain_size = self.n_items + 1  # + the IDLE slot
        self.stocking = np.asarray(stocking, np.int64)
        self.changeover = np.asarray(changeover, np.int64)
        self.demands = np.asarray(demands, np.int64)  # [n_items, horizon]
        H, N = self.horizon, self.n_items
        prev = np.full((N, H + 1), -1, np.int64)
        for t in range(1, H + 1):
            for i in range(N):
                prev[i, t] = t - 1 if self.demands[i][t - 1] > 0 else prev[i, t - 1]
        self._prev_np = prev
        self._host = dict(stocking=self.stocking, changeover=self.changeover,
                          prev_tbl=prev, rem_tbl=np.cumsum(self.demands, axis=1),
                          mst=_greedy_mst_table(self.changeover))
        self._data = {}

    @classmethod
    def from_numpy(cls, horizon, stocking, changeover, demands) -> "Psp":
        """The port's model of the instance a ddo_tpu `Psp` holds
        (`pb.horizon`, `pb.stocking`, `pb.changeover`, `pb.demands`)."""
        return cls(horizon, stocking, changeover, demands)

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            d = {k: torch.as_tensor(v, dtype=I32, device=device) for k, v in self._host.items()}
            d["demand_times"] = torch.as_tensor(self.demands > 0, device=device)
            d["min_stock"] = torch.as_tensor(self.stocking.min(), dtype=I32, device=device)
            self._data[device] = d
        return self._data[device]

    def initial_state(self):
        return {"heads": self._prev_np[:, self.horizon].astype(np.int32),
                "next": np.asarray(IDLE, np.int32)}

    def var_order(self):
        return np.arange(self.horizon, dtype=np.int32)[::-1].copy()

    def step(self, data, states, var, depth):
        N, H = self.n_items, self.horizon
        t = var.to(I32)[:, None]  # the period, [B, 1]
        heads, nxt = states["heads"], states["next"]  # [B, N], [B]
        items = torch.arange(N, device=heads.device)
        # gathers clip their indices, as ddo_tpu's do (a merge of no rows
        # leaves heads at INF)
        rem = torch.where(heads >= 0, data["rem_tbl"][items, torch.clamp(heads, 0, H - 1).long()],
                          0).sum(dim=1, dtype=I32)[:, None]
        alive = rem <= t + 1
        valid = torch.cat([alive & (heads >= t), alive & (rem < t + 1)], dim=1)

        co = data["changeover"][items[None, :], torch.clamp(nxt, 0, N - 1).long()[:, None]]
        co = torch.where(nxt[:, None] >= 0, co, 0)
        cost = -(co + data["stocking"] * (heads - t))  # [B, N]
        cost = torch.cat([cost, torch.zeros_like(cost[:, :1])], dim=1)

        new_head = data["prev_tbl"][items, torch.clamp(heads, 0, H).long()]  # [B, N]
        own = torch.eye(N + 1, N, dtype=torch.bool, device=heads.device)  # slot d, item k
        nheads = torch.where(own, new_head[:, None, :], heads[:, None, :])  # [B, D, N]
        nnext = torch.cat([items.to(I32).expand(heads.shape[0], N), nxt[:, None]], dim=1)
        dval = torch.arange(N + 1, dtype=I32, device=heads.device)
        dval = torch.where(dval == N, IDLE, dval).expand_as(valid)
        return {"heads": nheads, "next": nnext}, cost, dval, valid

    def pack(self, states):
        return torch.cat([states["heads"], states["next"][:, None]], dim=1)


class PspRelax(Relaxation):
    def __init__(self, problem: Psp):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        heads = torch.where(mask[:, :, None], states["heads"], INF).amin(dim=1)
        return {"heads": heads, "next": torch.full_like(heads[:, 0], IDLE)}

    def rub(self, data, states, depth):
        N, H = self.problem.n_items, self.problem.horizon
        heads, nxt = states["heads"], states["next"]
        B, dev = heads.shape[0], heads.device
        # the changeover bound of the member set (ub_utils.rs)
        bit = 1 << torch.arange(N, dtype=I32, device=dev)
        members = torch.where(heads >= 0, bit, 0).sum(dim=1, dtype=I32)
        members = members | torch.where(nxt >= 0, 1 << torch.clamp(nxt, 0, N - 1), 0)
        co = data["mst"][members.long()]

        # stocking bound: the pending deadlines (every demand period <=
        # its head, one production slot per period) packed earliest
        # deadline first; delays costed at the least stocking rate
        time = H - depth  # production slots left: 0..time-1
        tgrid = torch.arange(H, dtype=I32, device=dev)
        pending = data["demand_times"] & (tgrid <= heads[:, :, None])  # [B, N, H]
        deadlines = torch.where(pending.reshape(B, N * H), tgrid.repeat(N), -(1 << 20))
        dl = -torch.sort(-deadlines, dim=1).values  # descending
        j = torch.arange(N * H, dtype=I32, device=dev)
        e = torch.clamp(dl, max=time - 1)
        slots = torch.cummin(e + j, dim=1).values - j  # min_{k<=j}(e_k + k) - j
        delay = torch.where(dl >= 0, dl - slots, 0).sum(dim=1, dtype=I32)
        return (-(co + data["min_stock"] * delay)).to(I32)


class PspRanking(StateRanking):
    """model.rs PspRanking: a larger total head time first."""

    def score(self, data, states):
        return states["heads"].sum(dim=1, dtype=I32)[:, None]

    def score_host(self, state):
        return int(np.asarray(state["heads"]).sum())


def read_instance(path: str):
    """io_utils.rs: horizon, n_items, n_orders, blank, changeover matrix,
    stocking costs, blank, demand rows; a trailing line is the known
    optimum.  Returns (Psp, optimum or None)."""
    with open(path) as f:
        lines = [l.strip() for l in f]
    idx = 0

    def next_nonblank():
        nonlocal idx
        while idx < len(lines) and not lines[idx]:
            idx += 1
        line = lines[idx]
        idx += 1
        return line

    horizon = int(next_nonblank())
    n_items = int(next_nonblank())
    next_nonblank()  # n_orders
    changeover = [[int(x) for x in next_nonblank().split()] for _ in range(n_items)]
    stocking = [int(x) for x in next_nonblank().split()]
    demands = [[int(x) for x in next_nonblank().split()] for _ in range(n_items)]
    optimum = None
    try:
        optimum = int(next_nonblank())
    except (IndexError, ValueError):
        pass
    return Psp(horizon, stocking, changeover, demands), optimum


def generate_random(horizon: int, n_items: int, seed: int) -> Psp:
    """A seeded feasible instance: each (item, period) a unit demand with
    probability 0.35, thinned until the demand due by every period fits
    the periods elapsed; stocking costs in [1, 10), changeovers in [0, 15)
    with a zero diagonal."""
    rng = np.random.default_rng(seed)
    demands = (rng.random((n_items, horizon)) < 0.35).astype(np.int64)
    for t in range(horizon):
        while demands[:, : t + 1].sum() > t + 1:
            nz = np.argwhere(demands[:, : t + 1])
            i, tt = nz[rng.integers(len(nz))]
            demands[i, tt] = 0
    changeover = rng.integers(0, 15, (n_items, n_items))
    np.fill_diagonal(changeover, 0)
    return Psp(horizon, rng.integers(1, 10, n_items), changeover, demands)
