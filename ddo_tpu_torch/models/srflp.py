"""Single-row facility layout, batch-first: counterpart of
`ddo_tpu/models/srflp.py`.

Reference model: ddo/examples/srflp/{state,model,relax,heuristics,
io_utils}.rs
  * state = the must/maybe placement sets (int32 words) and the cut flow
    of every department (state.rs SrflpState);
  * transition: the placed department's flow row adds to the cuts of the
    departments still to place (model.rs transition); cost = -(the cuts
    of the departments that remain) * length[d] (model.rs
    transition_cost);
  * merge: must intersection, maybe union, per-entry min cut over the
    states that still carry the entry (relax.rs merge);
  * rough bound (relax.rs fast_upper_bound): sorted flows times cumulated
    shortest lengths, plus a greedy order by cut/length ratio, the ratio a
    float32 division as in the reference;
  * objective: reported = root_value - best_value (main.rs: 0.5 * sum
    (l_i + l_j) * f_ij).

int32 products (the flows times the cumulated lengths, the cuts times
the cumulated lengths) wrap as ddo_tpu's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking
from ddo_tpu_torch.models.tsptw import TsptwWidth
from ddo_tpu_torch.ops import bitset as bs
from ddo_tpu_torch.ops.sort import multi_sort_plain
from ddo_tpu_torch.utils.num import INF

I32 = torch.int32
F32 = torch.float32


class Srflp(Problem):
    name = "srflp"

    def __init__(self, lengths, flows):
        self.lengths = np.asarray(lengths, np.int64)
        self.flows = np.asarray(flows, np.int64)
        n = self.nb_variables = int(self.lengths.shape[0])
        self.domain_size = n
        iu = np.triu_indices(n, 1)
        self.root_value = float(
            0.5 * ((self.lengths[iu[0]] + self.lengths[iu[1]]) * self.flows[iu]).sum())
        # lengths ascending by (l, i) (model.rs:13-15); flows ascending by
        # (f, i, j) (model.rs:16-22)
        self._sl = sorted((int(l), i) for i, l in enumerate(self.lengths))
        self._sf = sorted((int(self.flows[i][j]), i, j) for i, j in zip(*iu))
        self._data = {}

    @classmethod
    def from_numpy(cls, lengths, flows) -> "Srflp":
        """The port's model of the instance a ddo_tpu `Srflp` holds
        (`pb.lengths`, `pb.flows`)."""
        return cls(lengths, flows)

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            n = self.nb_variables
            t = lambda a: torch.as_tensor(np.asarray(a, np.int64), dtype=I32, device=device)
            ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
            eye = np.eye(n, dtype=bool)
            without = np.zeros((n, bs.nb_lanes(n)), np.uint32)
            for d in range(n):
                without[d, d // 32] = np.uint32(1) << np.uint32(d % 32)
            self._data[device] = dict(
                lengths=t(self.lengths), flows=t(self.flows),
                sl_l=t([x[0] for x in self._sl]), sl_i=ix([x[1] for x in self._sl]),
                sf_f=t([x[0] for x in self._sf]), sf_i=ix([x[1] for x in self._sf]),
                sf_j=ix([x[2] for x in self._sf]),
                eye=torch.as_tensor(eye, device=device),
                without=torch.as_tensor(~without.view(np.int32), device=device))
        return self._data[device]

    def initial_state(self):
        n = self.nb_variables
        return {"must": bs.full_set_np(n), "maybe": np.zeros(bs.nb_lanes(n), np.int32),
                "cut": np.zeros(n, np.int32)}

    def step(self, data, states, var, depth):
        n = self.nb_variables
        must_bits = bs.to_bits(states["must"], n)  # [B, n]
        maybe_bits = bs.to_bits(states["maybe"], n)
        cut = states["cut"][:, None, :]  # [B, 1, n]; entries k of slot d below
        ca = n - depth - must_bits.sum(dim=1, dtype=I32)
        valid = must_bits | (maybe_bits & (ca > 0)[:, None])

        # transition cost (model.rs transition_cost): the cuts of the other
        # must entries + the smallest (n - depth - 1 - |must \ d|) maybe cuts
        other = ~data["eye"]  # [D, n]
        other_must = must_bits[:, None, :] & other  # [B, D, n]
        other_maybe = maybe_bits[:, None, :] & other
        cut_sum = torch.where(other_must, cut, 0).sum(dim=2, dtype=I32)
        ca2 = n - (depth + 1) - other_must.sum(dim=2, dtype=I32)
        mc = torch.sort(torch.where(other_maybe, cut, INF), dim=2).values
        csum = torch.cumsum(torch.where(mc < INF, mc, 0), dim=2, dtype=I32)
        csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=2)
        take = torch.clamp(torch.minimum(ca2, other_maybe.sum(dim=2, dtype=I32)), 0, n)
        cut_sum = cut_sum + torch.where(ca2 > 0, csum.gather(2, take[..., None].long())[..., 0],
                                        0)
        cost = -(cut_sum * data["lengths"])

        # transition (model.rs transition)
        ncut = torch.where(other_must | other_maybe, cut + data["flows"], cut)
        ncut = torch.where(data["eye"], 0, ncut)
        without = data["without"]
        nstate = {"must": states["must"][:, None] & without,
                  "maybe": states["maybe"][:, None] & without, "cut": ncut}
        dval = torch.arange(n, dtype=I32, device=valid.device).expand_as(valid)
        return nstate, cost, dval, valid

    def pack(self, states):
        return torch.cat([states["must"], states["maybe"], states["cut"]], dim=1)

    def unpack(self, cols):
        L = bs.nb_lanes(self.nb_variables)
        cols = np.asarray(cols, np.int32)
        return {"must": cols[:L], "maybe": cols[L : 2 * L], "cut": cols[2 * L :]}


class SrflpRelax(Relaxation):
    def __init__(self, problem: Srflp):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """relax.rs merge: per-entry min cut over carriers, INF elsewhere."""
        n = self.problem.nb_variables
        m = mask[:, :, None]
        agree = bs.and_reduce(torch.where(m, states["must"], -1), dim=1)
        all_must = bs.or_reduce(torch.where(m, states["must"], 0), dim=1)
        all_maybe = bs.or_reduce(torch.where(m, states["maybe"], 0), dim=1)
        carrier = m & bs.to_bits(states["must"] | states["maybe"], n)
        cut = torch.where(carrier, states["cut"], INF).amin(dim=1)
        return {"must": agree, "maybe": (all_maybe | all_must) & ~agree, "cut": cut}

    def rub(self, data, states, depth):
        """relax.rs fast_upper_bound."""
        n = self.problem.nb_variables
        m = n * (n - 1) // 2
        dev = states["cut"].device
        must_bits = bs.to_bits(states["must"], n)  # [B, n]
        maybe_bits = bs.to_bits(states["maybe"], n)
        cut = states["cut"]

        ca = n - depth
        n_must = must_bits.sum(dim=1, dtype=I32)
        n_fm = (ca - n_must)[:, None]  # departments taken from the maybe pool
        n_flows = ca * (ca - 1) // 2

        # --- length selection along the ascending (l, i) order ------------
        sl_l = data["sl_l"]
        is_must = must_bits[:, data["sl_i"]]
        is_maybe = maybe_bits[:, data["sl_i"]]
        sel_maybe = is_maybe & (torch.cumsum(is_maybe, dim=1, dtype=I32) <= n_fm)
        sel = is_must | sel_maybe
        lengths_sel = torch.sort(torch.where(sel, sl_l, INF), dim=1).values
        maybe_lengths = torch.sort(torch.where(sel_maybe, sl_l, INF), dim=1).values

        # --- flow selection along the ascending (f, i, j) order ------------
        fi, fj, ff = data["sf_i"], data["sf_j"], data["sf_f"]
        mi, mj = must_bits[:, fi], must_bits[:, fj]
        bi, bj = maybe_bits[:, fi], maybe_bits[:, fj]
        cat_mb = (mi & bj) | (bi & mj)
        cat_bb = bi & bj
        q_mb = n_must[:, None] * n_fm
        q_bb = n_fm * torch.clamp(n_fm - 1, min=0) // 2
        sel_mb = cat_mb & (torch.cumsum(cat_mb, dim=1, dtype=I32) <= q_mb)
        sel_bb = cat_bb & (torch.cumsum(cat_bb, dim=1, dtype=I32) <= q_bb)
        fsel = (mi & mj) | sel_mb | sel_bb
        flows_desc = -torch.sort(torch.where(fsel, -ff, 1), dim=1).values

        # --- edge bound: the largest flows x cumulated shortest lengths:
        # group g holds (ca-1-g) flows, its multiplier the prefix length sum
        # up to g
        g_ids = torch.arange(n, dtype=I32, device=dev)
        offs = g_ids * (ca - 1) - g_ids * (g_ids - 1) // 2
        offs = torch.where(g_ids < ca, offs, 1 << 30)
        idxs = torch.arange(m, dtype=I32, device=dev)
        grp = (offs[None, :] <= idxs[:, None]).sum(dim=1, dtype=I32) - 1
        lens_real = torch.where(lengths_sel < INF, lengths_sel, 0)
        cumlen = torch.cumsum(lens_real, dim=1, dtype=I32)
        cumlen = torch.cat([torch.zeros_like(cumlen[:, :1]), cumlen], dim=1)
        mult = cumlen[:, torch.clamp(grp, 0, n - 1).long()]
        edge_bound = torch.where(idxs < n_flows, mult * torch.clamp(flows_desc, min=0),
                                 0).sum(dim=1, dtype=I32)

        # --- cut bound: greedy by descending cut/length ratio.  Must
        # entries use their own (cut, length); the k-th smallest maybe
        # length pairs with the (n_fm-1-k)-th smallest maybe cut
        mlen_real = torch.where(maybe_lengths < INF, maybe_lengths, 1)
        mcut_asc = torch.sort(torch.where(maybe_bits, cut, INF), dim=1).values
        karr = torch.arange(n, device=dev)
        pair_valid = karr < n_fm
        mcut_desc = mcut_asc.gather(1, torch.clamp(n_fm - 1 - karr, 0, n - 1).long())
        ratio_c = torch.cat([torch.where(must_bits, cut, 0),
                             torch.where(pair_valid, mcut_desc, 0)], dim=1)
        ratio_l = torch.cat([torch.where(must_bits, data["lengths"], 1),
                             torch.where(pair_valid, mlen_real, 1)], dim=1)
        ratio_on = torch.cat([must_bits, pair_valid], dim=1)
        ratio = ratio_c.to(F32) / ratio_l.to(F32)
        # by (ratio, l, c) descending, inactive last: rows tied on all four
        # keys carry equal payloads, so any correct sort gives one result
        _, _, _, _, s_on, s_l, s_c = multi_sort_plain(
            ((~ratio_on).to(I32), -ratio, -ratio_l, -ratio_c, ratio_on, ratio_l, ratio_c), 4)
        lens2 = torch.where(s_on, s_l, 0)
        cum2 = torch.cumsum(lens2, dim=1, dtype=I32) - lens2  # exclusive prefix
        cut_bound = torch.where(s_on, cum2 * s_c, 0).sum(dim=1, dtype=I32)
        return (-(cut_bound + edge_bound)).to(I32)


class SrflpRanking(StateRanking):
    """heuristics.rs SrflpRanking compares depth: constant in a layer."""

    def score(self, data, states):
        return torch.zeros((states["cut"].shape[0], 1), dtype=I32,
                           device=states["cut"].device)

    def score_host(self, state):
        return 0


class SrflpWidth(TsptwWidth):
    """heuristics.rs: nb_vars * (depth + 1) * factor."""


def read_instance(path: str) -> Srflp:
    """io_utils.rs: n, lengths, flow matrix (commas allowed); files whose
    name contains "Cl" add a clearance of 10 to every length."""
    import os

    rows = []
    with open(path) as f:
        for line in f:
            line = line.replace(",", " ").strip()
            if line:
                rows.append([int(x) for x in line.split()])
    n = rows[0][0]
    lengths = rows[1][:n]
    flows = [r[:n] for r in rows[2 : 2 + n]]
    if "Cl" in os.path.basename(path):
        lengths = [l + 10 for l in lengths]
    return Srflp(lengths, flows)


def generate_random(n: int, seed: int) -> Srflp:
    """A seeded instance: lengths in [1, 10), symmetric flows in [0, 10)
    with a zero diagonal (the layout of the Anjos and sko instance
    files)."""
    rng = np.random.default_rng(seed)
    flows = np.triu(rng.integers(0, 10, (n, n)), 1)
    return Srflp(rng.integers(1, 10, n), flows + flows.T)
