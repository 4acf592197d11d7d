"""Talent scheduling, batch-first: counterpart of
`ddo_tpu/models/talentsched.py`.

Reference model: ddo/examples/talentsched/model.rs
  * state = {scenes still to schedule, maybe-scenes} as scene bitsets
    (model.rs TalentSchedState);
  * domain = schedulable scenes; maybe-scenes allowed only while more
    positions than certain scenes remain (model.rs for_each_in_domain);
  * cost = pay for present-but-idle actors during the scheduled scene
    (model.rs transition_cost, get_present);
  * merge: scenes intersection, maybes union (model.rs merge);
  * rough bound: fractional actor-payment bound (model.rs
    fast_upper_bound), computed in float32 with a +1/1e-5 slack so float
    rounding can only loosen (never falsely tighten) the bound;
  * ranking = |scenes| + |maybe| (model.rs TalentSchedRanking).
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Problem, Relaxation, StateRanking
from ddo_tpu_torch.ops import bitset as bs

I32 = torch.int32
F32 = torch.float32


class TalentSched(Problem):
    name = "talentsched"

    def __init__(self, nb_scenes, nb_actors, cost, duration, actors):
        self.nb_variables = int(nb_scenes)
        self.domain_size = int(nb_scenes)
        self.nb_actors = int(nb_actors)
        self.cost = np.asarray(cost, np.int64)
        self.duration = np.asarray(duration, np.int64)
        self.actor_mat = np.asarray(actors, np.int64)  # [A, n] incidence
        self.initial = -int(
            (self.actor_mat * self.cost[:, None] * self.duration[None, :]).sum())
        self._data = {}

    @classmethod
    def from_numpy(cls, cost, duration, actor_mat) -> "TalentSched":
        """The port's model of the instance a ddo_tpu `TalentSched` holds
        (`pb.cost`, `pb.duration`, `pb.actor_mat`)."""
        actor_mat = np.asarray(actor_mat)
        return cls(actor_mat.shape[1], actor_mat.shape[0], cost, duration, actor_mat)

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            n = self.nb_variables
            single = np.zeros((n, bs.nb_lanes(n)), np.uint32)
            for d in range(n):
                single[d, d // 32] = np.uint32(1) << np.uint32(d % 32)
            self._data[device] = dict(
                cost=torch.as_tensor(self.cost, dtype=I32, device=device),
                duration=torch.as_tensor(self.duration, dtype=I32, device=device),
                scene_actors=torch.as_tensor(self.actor_mat.T.astype(bool),
                                             device=device),  # [n, A]
                # ~{d} for every scene d, to remove a scene from a set
                without=torch.as_tensor(~single.view(np.int32), device=device),
            )
        return self._data[device]

    def initial_state(self):
        n = self.nb_variables
        return {"scenes": bs.full_set_np(n),
                "maybe": np.zeros(bs.nb_lanes(n), np.int32)}

    def initial_value(self) -> int:
        return self.initial

    @staticmethod
    def _present(data, scenes_bits, maybe_bits):
        """model.rs get_present: actors needed both by an already-scheduled
        scene and by a still-to-schedule scene, bool [B, A]."""
        decided = ~scenes_bits & ~maybe_bits  # [B, n]
        sa = data["scene_actors"]  # [n, A]
        after = (sa & scenes_bits[:, :, None]).any(dim=1)
        before = (sa & decided[:, :, None]).any(dim=1)
        return before & after

    def step(self, data, states, var, depth):
        n = self.nb_variables
        scenes_bits = bs.to_bits(states["scenes"], n)  # [B, n]; slot d = scene d
        maybe_bits = bs.to_bits(states["maybe"], n)
        count = scenes_bits.sum(dim=1)
        maybe_ok = (var + count) < n
        valid = scenes_bits | (maybe_bits & maybe_ok[:, None])

        present = self._present(data, scenes_bits, maybe_bits)  # [B, A]
        pay = present[:, None] & ~data["scene_actors"]  # [B, n, A]
        cost = -(torch.where(pay, data["cost"], 0).sum(dim=2) * data["duration"])

        nstate = {"scenes": states["scenes"][:, None] & data["without"],
                  "maybe": states["maybe"][:, None] & data["without"]}
        dval = torch.arange(n, dtype=I32, device=valid.device).expand_as(valid)
        return nstate, cost.to(I32), dval, valid

    def pack(self, states):
        return torch.cat([states["scenes"], states["maybe"]], dim=1)

    def unpack(self, cols):
        L = bs.nb_lanes(self.nb_variables)
        cols = np.asarray(cols, np.int32)
        return {"scenes": cols[:L], "maybe": cols[L:2 * L]}


class TalentSchedRelax(Relaxation):
    def __init__(self, problem: TalentSched):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """model.rs merge: scenes = intersection, maybes = union minus."""
        m3 = mask[:, :, None]
        scenes = bs.and_reduce(torch.where(m3, states["scenes"], -1), dim=1)
        union = bs.or_reduce(
            torch.where(m3, states["scenes"] | states["maybe"], 0), dim=1)
        return {"scenes": scenes, "maybe": union & ~scenes}

    def rub(self, data, states, depth):
        """Fractional payment bound (model.rs fast_upper_bound)."""
        pb = self.problem
        n = pb.nb_variables
        scenes_bits = bs.to_bits(states["scenes"], n)
        maybe_bits = bs.to_bits(states["maybe"], n)
        present = pb._present(data, scenes_bits, maybe_bits)  # [B, A]
        sa = data["scene_actors"]  # [n, A]
        pa = sa & present[:, None] & scenes_bits[:, :, None]  # [B, n, A]
        costs = data["cost"].to(F32)
        zero = torch.zeros((), dtype=F32, device=costs.device)
        tc = torch.where(pa, costs, zero).sum(dim=2)  # [B, n]
        tc2 = torch.where(pa, costs ** 2, zero).sum(dim=2)
        nonempty = tc > 0
        dur = data["duration"].to(F32)
        safe_tc = torch.where(nonempty, tc, 1.0)
        lb = -torch.where(nonempty, dur * (tc + tc2 / safe_tc) / 2.0, zero).sum(dim=1)
        r = torch.where(pa, (dur / safe_tc)[:, :, None], zero).sum(dim=1)  # [B, A]
        # actors ordered by increasing r (ties by index): prefix-weighted sum
        r_s, idx_s = torch.sort(r, dim=1, stable=True)
        cost_s = costs[idx_s]
        pres_s = present.gather(1, idx_s)
        sum_e = torch.where(pres_s, r_s * cost_s, zero).cumsum(dim=1)
        lb = lb + torch.where(pres_s, cost_s * sum_e, zero).sum(dim=1)
        ub = -torch.ceil(lb)
        # float32 slack: only ever loosen the bound.  The sums above round
        # by their order of addition, which differs between a card and the
        # CPU, so where `lb` is an integer the two may differ by one.
        slack = torch.ceil(ub.abs() * 1e-5) + 1
        return (ub + slack).to(I32)


class TalentSchedRanking(StateRanking):
    """|scenes| + |maybe| (model.rs TalentSchedRanking)."""

    def score(self, data, states):
        return (bs.count(states["scenes"]) + bs.count(states["maybe"]))[:, None]

    def score_host(self, state):
        return sum(bin(int(x)).count("1")
                   for words in (state["scenes"], state["maybe"])
                   for x in np.asarray(words, np.int32).view(np.uint32))


def read_instance(path: str) -> TalentSched:
    """io_utils.rs read_instance: name line, nb_scenes, nb_actors, then
    per-actor scene incidences + cost, finally the scene durations."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    lines = lines[1:]  # instance name
    first = lines[0].split()
    if len(first) >= 2:
        nb_scenes, nb_actors = int(first[0]), int(first[1])
        rest = lines[1:]
    else:
        nb_scenes = int(first[0])
        nb_actors = int(lines[1].split()[0])
        rest = lines[2:]
    actors, cost = [], []
    for i in range(nb_actors):
        nums = [int(x) for x in rest[i].split()]
        actors.append(nums[:nb_scenes])
        cost.append(nums[nb_scenes])
    duration = [int(x) for x in rest[nb_actors].split()[:nb_scenes]]
    return TalentSched(nb_scenes, nb_actors, cost, duration, actors)


def generate_random(nb_scenes: int, nb_actors: int, seed: int) -> TalentSched:
    """A seeded random instance: each actor plays in each scene with
    probability 1/2 (and in at least one), costs in [1, 9], durations in
    [1, 4]."""
    rng = np.random.default_rng(seed)
    actors = (rng.random((nb_actors, nb_scenes)) < 0.5).astype(np.int64)
    actors[np.arange(nb_actors), rng.integers(0, nb_scenes, nb_actors)] = 1
    return TalentSched(nb_scenes, nb_actors, rng.integers(1, 10, nb_actors),
                       rng.integers(1, 5, nb_scenes), actors)
