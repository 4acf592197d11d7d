"""Aircraft landing, batch-first: counterpart of `ddo_tpu/models/alp.py`.

Reference model: ddo/examples/alp/{model,dominance,io_utils}.rs
  * state = the aircraft still to land per class, and per runway its last
    (time, class), kept sorted for runway symmetry breaking (model.rs
    AlpState / transition);
  * decision value = class + nb_classes * runway, or DUMMY (-1) once every
    aircraft has landed (model.rs to_decision / for_each_in_domain);
  * a state dies when some class's next aircraft can land on no runway
    (model.rs:135-138); a runway equal to the one before it is branched
    once;
  * arrival = max(target, previous time + separation), an unknown (DUMMY)
    previous class taking the least separation into the class (model.rs
    get_arrival_time); cost = -(arrival - target);
  * merge: elementwise min of the counts and times, DUMMY classes
    (model.rs AlpRelax::merge);
  * ranking = total runway time (model.rs AlpRanking);
  * dominance: key = (counts, runway classes), coordinates = -runway
    times, with value (dominance.rs).

Rough bound, the one documented divergence from ddo_tpu: ddo_tpu's
per-class queueing bound (`AlpRelax.rub`) is admissible only when the
separations are non-negative and obey the triangle inequality
(sep[a][c] <= sep[a][b] + sep[b][c]).  The port checks this at
construction (`Alp.queueing_rub`) and otherwise bounds with 0, as the
reference does (model.rs:250-252).  ddo_tpu uses the queueing bound on
every instance.
"""

from __future__ import annotations

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Dominance, Problem, Relaxation, StateRanking
from ddo_tpu_torch.ops.sort import multi_sort_plain
from ddo_tpu_torch.utils.num import INF

I32 = torch.int32
DUMMY = -1


def separation_admissible(sep) -> bool:
    """Whether separations are non-negative and obey the triangle
    inequality, which the queueing bound's proof needs."""
    sep = np.asarray(sep, np.int64)
    via = (sep[:, :, None] + sep[None, :, :]).min(axis=1)  # min_b sep[a][b] + sep[b][c]
    return bool((sep >= 0).all() and (sep <= via).all())


class Alp(Problem):
    name = "alp"

    def __init__(self, nb_classes, nb_runways, target, latest, classes, separation):
        self.nb_classes = int(nb_classes)
        self.nb_runways = int(nb_runways)
        self.target = np.asarray(target, np.int64)
        self.latest = np.asarray(latest, np.int64)
        self.classes = np.asarray(classes, np.int64)
        self.sep = np.asarray(separation, np.int64)
        n = self.nb_variables = int(self.target.shape[0])
        C = self.nb_classes
        self.domain_size = C * self.nb_runways + 1  # + DUMMY
        #: whether the queueing rough bound is admissible here (else rub = 0)
        self.queueing_rub = separation_admissible(self.sep)
        # next[c][rem] = the aircraft of class c to land next (model.rs:31-35)
        nxt = np.zeros((C, n + 1), np.int64)
        fill = [[0] for _ in range(C)]
        for i in range(n - 1, -1, -1):
            fill[self.classes[i]].append(i)
        for c in range(C):
            nxt[c, : len(fill[c])] = fill[c]
        self.min_sep_to = self.sep.min(axis=0)
        # the queueing bound's tables (see AlpRelax.rub): tsort[c, m, k] =
        # the k-th smallest target among the m class-c planes still to land
        # (planes next[c][1..m]); off[c, k] = floor(k / R) * sep[c][c]
        tsort = np.zeros((C, n + 1, n), np.int64)
        for c in range(C):
            seq = fill[c][1:]
            for m in range(1, len(seq) + 1):
                tsort[c, m, :m] = np.sort(self.target[seq[:m]])
        off = (np.arange(n)[None, :] // max(1, self.nb_runways)) * np.diag(self.sep)[:, None]
        self._host = dict(target=self.target, latest=self.latest, classes=self.classes,
                          sep=self.sep, next=nxt, min_sep_to=self.min_sep_to,
                          rub_tsort=tsort, rub_off=off,
                          queueing_rub=np.asarray(self.queueing_rub))
        self._data = {}

    @classmethod
    def from_numpy(cls, nb_classes, nb_runways, target, latest, classes, sep) -> "Alp":
        """The port's model of the instance a ddo_tpu `Alp` holds
        (`pb.nb_classes`, `pb.nb_runways`, `pb.target`, `pb.latest`,
        `pb.classes`, `pb.sep`)."""
        return cls(nb_classes, nb_runways, target, latest, classes, sep)

    def data(self, device):
        device = torch.device(device)
        if device not in self._data:
            self._data[device] = {k: torch.as_tensor(v, dtype=I32, device=device)
                                  for k, v in self._host.items()}
        return self._data[device]

    def initial_state(self):
        return {"rem": np.bincount(self.classes, minlength=self.nb_classes).astype(np.int32),
                "rw_time": np.zeros(self.nb_runways, np.int32),
                "rw_class": np.full(self.nb_runways, DUMMY, np.int32)}

    def step(self, data, states, var, depth):
        C, R, n = self.nb_classes, self.nb_runways, self.nb_variables
        rem, rw_time, rw_class = states["rem"], states["rw_time"], states["rw_class"]
        B, dev = rem.shape[0], rem.device
        tot_rem = rem.sum(dim=1, dtype=I32)[:, None]
        classes_t = torch.arange(C, device=dev)
        craft = data["next"][classes_t, torch.clamp(rem, 0, n).long()].long()  # [B, C]
        # model.rs get_arrival_time for every (class, runway): [B, C, R]
        tgt = data["target"][craft][:, :, None]
        cls = data["classes"][craft].long()[:, :, None]
        known = rw_class[:, None, :]
        sep = torch.where(known == DUMMY, data["min_sep_to"][cls],
                          data["sep"][torch.clamp(known, 0, C - 1).long(), cls])
        fresh = ((rw_time == 0) & (rw_class == DUMMY))[:, None, :]
        arr = torch.where(fresh, tgt, torch.maximum(tgt, rw_time[:, None, :] + sep))
        feas = arr <= data["latest"][craft][:, :, None]
        all_ok = (feas.any(dim=2) | (rem == 0)).all(dim=1, keepdim=True)
        # runway symmetry: skip runway r when runway r-1 has the same
        # (time, class) (the infos are kept sorted)
        dup = torch.zeros_like(rw_time, dtype=torch.bool)
        dup[:, 1:] = (rw_time[:, 1:] == rw_time[:, :-1]) & (rw_class[:, 1:] == rw_class[:, :-1])

        # domain slot d = c + C * r: [B, R, C] flattened runway-major
        ok = (rem > 0)[:, None, :] & feas.transpose(1, 2) & ~dup[:, :, None] \
            & all_ok[:, :, None] & (tot_rem > 0)[:, :, None]
        valid = torch.cat([ok.reshape(B, R * C), tot_rem == 0], dim=1)
        arrival = arr.transpose(1, 2).reshape(B, R * C)
        aircraft = craft.repeat(1, R)  # slot d -> craft[d % C]
        cost = torch.cat([-(arrival - data["target"][aircraft]),
                          torch.zeros_like(arrival[:, :1])], dim=1)

        # the next state of slot (r, c): one class-c aircraft lands on r
        D = R * C
        c_of = torch.arange(D, device=dev) % C
        r_of = torch.arange(D, device=dev) // C
        nrem = rem[:, None, :] - (c_of[:, None] == classes_t).to(I32)  # [B, D, C]
        on_r = r_of[:, None] == torch.arange(R, device=dev)  # [D, R]
        nt = torch.where(on_r, arrival[:, :, None], rw_time[:, None, :])
        nc = torch.where(on_r, c_of.to(I32)[:, None], rw_class[:, None, :])
        # keep the runway infos sorted by (time, class) (model.rs transition)
        nt, nc = multi_sort_plain((nt.reshape(B * D, R), nc.reshape(B * D, R)), 2)
        nstate = {"rem": torch.cat([nrem, rem[:, None]], dim=1),
                  "rw_time": torch.cat([nt.reshape(B, D, R), rw_time[:, None]], dim=1),
                  "rw_class": torch.cat([nc.reshape(B, D, R), rw_class[:, None]], dim=1)}
        dval = torch.arange(D + 1, dtype=I32, device=dev)
        dval = torch.where(dval == D, DUMMY, dval).expand_as(valid)
        return nstate, cost, dval, valid

    def pack(self, states):
        # sorted-leaf order (rem, rw_class, rw_time), so that the default
        # unpack inverts it
        return torch.cat([states["rem"], states["rw_class"], states["rw_time"]], dim=1)


class AlpRelax(Relaxation):
    def __init__(self, problem: Alp):
        self.problem = problem

    def data(self, device):
        return self.problem.data(device)

    def merge(self, data, states, mask):
        """model.rs AlpRelax::merge: min counts, min times, DUMMY classes."""
        m = mask[:, :, None]
        t = torch.where(m, states["rw_time"], INF).amin(dim=1)
        return {"rem": torch.where(m, states["rem"], INF).amin(dim=1), "rw_time": t,
                "rw_class": torch.full_like(t, DUMMY)}

    def rub(self, data, states, depth):
        """ddo_tpu's per-class queueing bound where it is admissible
        (`Alp.queueing_rub`, read from the data), else 0 (model.rs:250-252).

        Per class c with m planes still to land: in any completion the
        k-th smallest class-c landing is >= b_c + floor((k-1)/R) *
        sep[c][c] (b_c the earliest a runway is free for class c) and >=
        the k-th smallest remaining target, so the class's delay is at
        least sum_k max(0, b_c + off_k - tsort_k); the classes' bounds
        add."""
        pb = self.problem
        rem = states["rem"]
        C, n = pb.nb_classes, pb.nb_variables
        rw_time, rw_class = states["rw_time"], states["rw_class"]
        known = rw_class[:, None, :]  # [B, 1, R]
        classes_t = torch.arange(C, device=rem.device)
        sep_in = torch.where(known == DUMMY, data["min_sep_to"][:, None],
                             data["sep"][torch.clamp(known, 0, C - 1).long(),
                                         classes_t[:, None]])  # [B, C, R]
        fresh = ((rw_time == 0) & (rw_class == DUMMY))[:, None, :]
        b = torch.where(fresh, 0, rw_time[:, None, :] + sep_in).amin(dim=2)  # [B, C]
        tsort = data["rub_tsort"][classes_t, torch.clamp(rem, 0, n).long()]  # [B, C, n]
        inplay = torch.arange(n, device=rem.device) < rem[:, :, None]
        delay = torch.where(inplay, torch.clamp(b[:, :, None] + data["rub_off"] - tsort, min=0),
                            0)
        return torch.where(data["queueing_rub"] != 0, -delay.sum(dim=(1, 2), dtype=I32), 0)


class AlpRanking(StateRanking):
    """model.rs AlpRanking: a larger total runway time first."""

    def score(self, data, states):
        return states["rw_time"].sum(dim=1, dtype=I32)[:, None]

    def score_host(self, state):
        return int(np.asarray(state["rw_time"]).sum())


class AlpDominance(Dominance):
    """dominance.rs: key = (counts, runway classes), coordinates = -runway
    times, with value."""

    use_value = True

    def key_cols(self, states):
        return torch.cat([states["rem"], states["rw_class"]], dim=1)

    def coord_cols(self, states):
        return -states["rw_time"]


def read_instance(path: str) -> Alp:
    """io_utils.rs: flat whitespace numbers: n, C, R, then per aircraft
    (target, latest, class), then the C x C separation matrix."""
    data = []
    with open(path) as f:
        for line in f:
            data.extend(int(x) for x in line.split())
    n, C, R = data[0], data[1], data[2]
    rows = np.asarray(data[3 : 3 + 3 * n], np.int64).reshape(n, 3)
    sep = np.asarray(data[3 + 3 * n : 3 + 3 * n + C * C], np.int64).reshape(C, C)
    return Alp(C, R, rows[:, 0], rows[:, 1], rows[:, 2], sep)


def generate_random(n: int, nb_classes: int, nb_runways: int, seed: int) -> Alp:
    """A seeded instance: sorted targets in [0, 60), latest = target +
    [30, 200), random classes, separations in [3, 15), redrawn until they
    obey the triangle inequality (so the queueing bound is on)."""
    rng = np.random.default_rng(seed)
    target = np.sort(rng.integers(0, 60, n))
    latest = target + rng.integers(30, 200, n)
    classes = rng.integers(0, nb_classes, n)
    sep = rng.integers(3, 15, (nb_classes, nb_classes))
    while not separation_admissible(sep):
        sep = rng.integers(3, 15, (nb_classes, nb_classes))
    return Alp(nb_classes, nb_runways, target, latest, classes, sep)
