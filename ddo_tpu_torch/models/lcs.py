"""Longest common subsequence of m strings, batch-first: counterpart of
`ddo_tpu/models/lcs.py`.

Reference model: ddo/examples/lcs/{model,dp,dominance}.rs
  * state = the current position in each string (model.rs LcsState);
  * domain = the characters still present in every string, else a single
    go-to-end decision (model.rs for_each_in_domain);
  * transition jumps every position past the next occurrence (model.rs
    transition, the precomputed `next` table);
  * long arcs (model.rs:162-165): a node branches only at the layer equal
    to its first-string position;
  * merge = min positions (model.rs merge);
  * rough bound = min(per-character remaining common count, the pairwise
    2-string LCS tables) (model.rs fast_upper_bound, dp.rs LcsDp);
  * ranking prefers a smaller total position (model.rs LcsRanking);
  * dominance: key = position[0], coordinates = -positions, with value
    (dominance.rs).

The `next`, `rem` and pair tables stay int32 and are gathered directly:
ddo_tpu holds them in float32 and reads them by one-hot contractions on
the TPU's matrix unit, which a GPU does not need.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Dominance, Problem, Relaxation, StateRanking

I32 = torch.int32
GO_TO_END = -1


def _lcs_table(a, b):
    """Classic 2-string LCS suffix table (dp.rs LcsDp.solve)."""
    la, lb = len(a), len(b)
    t = np.zeros((la + 1, lb + 1), np.int64)
    for i in range(la - 1, -1, -1):
        for j in range(lb - 1, -1, -1):
            t[i, j] = max(t[i + 1, j], t[i, j + 1], t[i + 1, j + 1] + (a[i] == b[j]))
    return t


class Lcs(Problem):
    name = "lcs"

    def __init__(self, strings, n_chars: int):
        self.strings = [np.asarray(s, np.int64) for s in strings]
        self.n_strings = len(strings)
        self.n_chars = int(n_chars)
        self.lengths = np.array([len(s) for s in self.strings], np.int64)
        self.nb_variables = int(self.lengths[0])
        self.domain_size = self.n_chars + 1  # chars + the go-to-end slot
        L = int(self.lengths.max()) + 1

        nxt = np.full((self.n_strings, self.n_chars, L + 1), L, np.int64)
        rem = np.zeros((self.n_strings, self.n_chars, L + 1), np.int64)
        for i, s in enumerate(self.strings):
            for pos in range(len(s) - 1, -1, -1):
                nxt[i, :, pos] = nxt[i, :, pos + 1]
                rem[i, :, pos] = rem[i, :, pos + 1]
                nxt[i, s[pos], pos] = pos
                rem[i, s[pos], pos] += 1
        tables = np.zeros((max(1, self.n_strings - 1), L + 1, L + 1), np.int64)
        for i in range(self.n_strings - 1):
            t = _lcs_table(self.strings[i], self.strings[i + 1])
            tables[i, : t.shape[0], : t.shape[1]] = t
        self._host = dict(next=nxt, rem=rem, tables=tables, lengths=self.lengths)
        self._data = {}

    @classmethod
    def from_numpy(cls, strings, n_chars) -> "Lcs":
        """The port's model of the instance a ddo_tpu `Lcs` holds
        (`pb.strings`, `pb.n_chars`)."""
        return cls(strings, n_chars)

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            self._data[device] = {k: torch.as_tensor(v, dtype=I32, device=device)
                                  for k, v in self._host.items()}
        return self._data[device]

    def initial_state(self):
        return {"pos": np.zeros(self.n_strings, np.int32)}

    def _lookup(self, table, pos):
        """table[i, c, pos[b, i]] for every string i and character c:
        [B, m, n_chars]; 0 where a position is off the table (ddo_tpu's
        one-hot lookup gives 0 there)."""
        m, nc, Lr = table.shape
        inside = (pos >= 0) & (pos < Lr)
        rows = table[torch.arange(m, device=pos.device)[None, :, None],
                     torch.arange(nc, device=pos.device)[None, None, :],
                     torch.clamp(pos, 0, Lr - 1)[:, :, None].long()]
        return torch.where(inside[:, :, None], rows, 0)

    def step(self, data, states, var, depth):
        pos = states["pos"]  # [B, m]
        B, nc = pos.shape[0], self.n_chars
        remmat = self._lookup(data["rem"], pos)
        char_ok = (remmat > 0).all(dim=1)  # [B, n_chars]
        # the go-to-end slot is valid only when no character is left in
        # every string (model.rs:103-118)
        valid = torch.cat([char_ok, ~char_ok.any(dim=1, keepdim=True)], dim=1)
        np_char = (self._lookup(data["next"], pos) + 1).transpose(1, 2)  # [B, n_chars, m]
        end = data["lengths"].expand(B, 1, self.n_strings)
        npos = torch.cat([np_char, end], dim=1)  # [B, D, m]
        cost = (torch.arange(nc + 1, device=pos.device) < nc).to(I32).expand(B, nc + 1)
        dval = torch.arange(nc + 1, dtype=I32, device=pos.device)
        dval = torch.where(dval == nc, GO_TO_END, dval).expand(B, nc + 1)
        return {"pos": npos}, cost, dval, valid

    def is_impacted_by(self, data, states, var):
        """Long arcs (model.rs:162-165): a node branches only at the layer
        equal to its first-string position; every other layer is crossed
        by a zero-cost identity arc."""
        return states["pos"][:, 0] == var

    def pack(self, states):
        return states["pos"]


class LcsRelax(Relaxation):
    def __init__(self, problem: Lcs):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        pos = torch.where(mask[:, :, None], states["pos"], 1 << 30).amin(dim=1)
        return {"pos": torch.minimum(pos, data["lengths"])}

    def rub(self, data, states, depth):
        pos = states["pos"]
        tot = self.problem._lookup(data["rem"], pos).amin(dim=1).sum(dim=1, dtype=I32)
        if self.problem.n_strings > 1:
            # tables[p, pos[p], pos[p+1]], 0 off the table
            tables = data["tables"]
            P, Lt, _ = tables.shape
            a, b = pos[:, :-1], pos[:, 1:]
            inside = (a >= 0) & (a < Lt) & (b >= 0) & (b < Lt)
            pair = tables[torch.arange(P, device=pos.device)[None, :],
                          torch.clamp(a, 0, Lt - 1).long(), torch.clamp(b, 0, Lt - 1).long()]
            tot = torch.minimum(tot, torch.where(inside, pair, 0).amin(dim=1))
        return tot.to(I32)


class LcsRanking(StateRanking):
    """A smaller total position first (model.rs LcsRanking)."""

    def score(self, data, states):
        return -states["pos"].sum(dim=1, dtype=I32)[:, None]

    def score_host(self, state):
        return -int(np.asarray(state["pos"]).sum())


class LcsDominance(Dominance):
    """dominance.rs: key = position[0], coordinates = -positions, with
    value."""

    use_value = True

    def key_cols(self, states):
        return states["pos"][:, :1]

    def coord_cols(self, states):
        return -states["pos"]


def read_instance(path: str) -> Lcs:
    """io_utils format: `n_strings n_chars`, then `len string` lines."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    n_strings, n_chars = (int(x) for x in lines[0].split())
    strings = []
    charmap = {}
    for line in lines[1 : 1 + n_strings]:
        s = []
        for ch in line.split()[1]:
            if ch not in charmap:
                charmap[ch] = len(charmap)
            s.append(charmap[ch])
        strings.append(s)
    return Lcs(strings, n_chars)


def generate_random(n_strings: int, n_chars: int, length: int, seed: int) -> Lcs:
    """A seeded instance: `n_strings` strings of `length` characters drawn
    uniformly from an alphabet of `n_chars` (the shape of the reference's
    random instances)."""
    rng = np.random.default_rng(seed)
    return Lcs([rng.integers(0, n_chars, length) for _ in range(n_strings)], n_chars)
