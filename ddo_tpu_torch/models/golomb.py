"""Golomb ruler, batch-first: counterpart of `ddo_tpu/models/golomb.py`.

Reference model: ddo/examples/golomb/main.rs
  * state = {marks bitset, pairwise-distance bitset, #marks, last mark}
    (main.rs:49-56), bitsets over positions [0, n^2+1] as int32 words;
  * domain = positions in (last, ub] whose distances to all marks are
    fresh (all-different, main.rs:81-95); ub from the known-optimum
    table pruning (main.rs:43-47);
  * cost = -(new - last) (minimize length as maximization);
  * merge = set intersections + min counts (main.rs:146-171);
  * rough bound = -known_optimal[n - #marks] (main.rs:174-177);
  * ranking = last mark (main.rs GolombRanking).

The distances a new mark at `pos` adds are the window w[j] = marks[pos - j].
ddo_tpu builds it by reversing the mark set and shifting it, because a
data-dependent gather serializes on its hardware; here it is one gather
over the unpacked bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking
from ddo_tpu_torch.ops import bitset as bs

I32 = torch.int32
_BIG = 1 << 30

KNOWN_OPTIMAL_COSTS = np.array(
    [0, 0, 1, 3, 6, 11, 17, 25, 34, 44, 55, 72, 85, 106, 127, 151, 177, 199,
     216, 246, 283, 333, 356, 372, 425, 480, 492, 553, 585], np.int64,
)


class Golomb(Problem):
    name = "golomb"

    def __init__(self, n: int):
        self.n = int(n)
        self.nb_variables = self.n - 1  # first mark pinned at 0
        self.P = self.n * self.n + 2  # position space for the bitsets
        # widest domain range: ub bounded by n^2+1, lb >= 1
        self.domain_size = (self.n * self.n + 1) // 2 + 1
        self._data = {}

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            self._data[device] = dict(
                known=torch.as_tensor(KNOWN_OPTIMAL_COSTS, dtype=I32, device=device))
        return self._data[device]

    def initial_state(self):
        marks = np.zeros(bs.nb_lanes(self.P), np.int32)
        marks[0] = 1
        return {"marks": marks, "dists": np.zeros_like(marks),
                "m": np.asarray(1, np.int32), "last": np.asarray(0, np.int32)}

    def step(self, data, states, var, depth):
        n, P, D = self.n, self.P, self.domain_size
        marks, dists = states["marks"], states["dists"]  # [B, L]
        last, m = states["last"], states["m"]  # [B]
        B, L = marks.shape
        dev = marks.device
        pos = last[:, None] + 1 + torch.arange(D, dtype=I32, device=dev)  # [B, D]
        # position upper bound from the known-optima table (main.rs:83-87)
        known = data["known"]
        top = known.shape[0] - 1
        ub = torch.where(
            m < n // 2,
            (n * n + 1) // 2 - known[torch.clamp(n // 2 - m, 0, top).long()],
            n * n + 1 - known[torch.clamp(n - m, 0, top).long()],
        )
        # window bit j = marks bit (pos - j), False outside the bit space
        Lb = 32 * L
        src = pos[:, :, None].long() - torch.arange(Lb, device=dev)  # [B, D, Lb]
        mark_bits = bs.to_bits(marks, Lb)[:, None].expand(B, D, Lb)
        win_bits = mark_bits.gather(2, src.clamp(0, Lb - 1)) & (src >= 0) & (src < Lb)
        mark_win = bs.from_bits(win_bits, Lb)  # [B, D, L]
        # clash: a mark j with (pos - j) already a known distance
        clash = ((dists[:, None] & mark_win) != 0).any(dim=2)
        valid = (pos <= ub[:, None]) & (pos < P) & ~clash

        # transition (main.rs:113-126): distances gain {pos - j : j in marks}
        flat_pos = pos.reshape(-1).clamp(0, P - 1).long()
        new_marks = bs.insert(marks[:, None].expand(B, D, L).reshape(B * D, L),
                              flat_pos).view(B, D, L)
        v3 = valid[:, :, None]
        nstate = {
            "marks": torch.where(v3, new_marks, marks[:, None]),
            "dists": torch.where(v3, dists[:, None] | mark_win, dists[:, None]),
            "m": (m + 1)[:, None].expand(B, D),
            "last": torch.where(valid, pos, last[:, None]),
        }
        return nstate, -(pos - last[:, None]), pos, valid

    def pack(self, states):
        return torch.cat([states["marks"], states["dists"],
                          states["m"][:, None], states["last"][:, None]], dim=1)

    def unpack(self, cols):
        L = bs.nb_lanes(self.P)
        cols = np.asarray(cols, np.int32)
        return {"marks": cols[:L], "dists": cols[L:2 * L],
                "m": cols[2 * L], "last": cols[2 * L + 1]}


class GolombRelax(Relaxation):
    def __init__(self, problem: Golomb):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """Set intersections + min counts (main.rs:146-171)."""
        m3 = mask[:, :, None]
        return {
            "marks": bs.and_reduce(torch.where(m3, states["marks"], -1), dim=1),
            "dists": bs.and_reduce(torch.where(m3, states["dists"], -1), dim=1),
            "m": torch.where(mask, states["m"], _BIG).amin(dim=1),
            "last": torch.where(mask, states["last"], _BIG).amin(dim=1),
        }

    def rub(self, data, states, depth):
        known = data["known"]
        k = torch.clamp(self.problem.n - states["m"], 0, known.shape[0] - 1)
        return -known[k.long()]


class GolombRanking(StateRanking):
    """Larger last mark preferred (main.rs GolombRanking)."""

    def score(self, data, states):
        return states["last"][:, None]

    def score_host(self, state):
        return int(np.asarray(state["last"]))
