"""Tutorial: defining your own problem for ddo_tpu_torch.

The PyTorch counterpart of `tutorial_custom_problem.py`: the same
walk-through of modelling **weighted interval scheduling** (pick
non-overlapping jobs maximizing total profit) and solving it to proved
optimality, written against the port's batch-first contract.

Run:  python examples/tutorial_custom_problem_torch.py          (on a card)
      python examples/tutorial_custom_problem_torch.py --cpu    (plain PyTorch)

The contract (ddo_tpu_torch/core/problem.py, mirroring the reference traits
in ddo/src/abstraction/dp.rs) asks for the same three things as ddo_tpu's:

  1. a `Problem`:   the DP formulation: states, the transition `step`,
                    the branching order;
  2. a `Relaxation`: how to *merge* several states into one that
                    over-approximates them all (this is what makes relaxed
                    DDs produce upper bounds), plus an optional fast upper
                    bound (RUB) used for pruning;
  3. a `StateRanking`: which states look promising (kept during
                    restriction, spared from merging during relaxation).

What changed from the JAX contract, and why:

  * **Every hook takes a leading batch dimension.**  ddo_tpu writes a hook
    for ONE state and lets `jax.vmap` batch it.  PyTorch has no tracer to
    do that cheaply, so the engine flattens its K lanes x W nodes into one
    batch B and calls each hook once per layer: `step` expands B states
    into [B, D, ...] children in one call, `merge` folds a [B, C] masked
    row of states per batch row, `rub` and `score` return one row per
    state.  Write hooks with tensor ops over that dimension (`torch.where`,
    broadcasting, gathers by index tensors), never a Python loop over it.
  * **States are dicts of tensors [B, ...].**  On the host (the root, a
    subproblem in the fringe) a state is the same dict of numpy arrays
    without the batch dimension: `initial_state()` returns that form.
  * **Instance data is built by `data(device)` on the compiler's device**
    and passed to every hook, where ddo_tpu reads a `data` property.  A
    compile on a card ("cuda") reads tensors that live on the card; cache
    them per device so each is copied once.
  * Integers are int32 throughout (values, costs, decisions, ranking
    scores), and validity masks are bool, as in ddo_tpu.
  * **`depth` may be a tensor.**  On a card the engine replays each layer
    from CUDA graphs and hands `step`, `rub` and `next_variable` the layer
    index as an int64 0-d tensor on the device; read a table's row with
    `depth_row(table, depth)` and branch with `depth_select(cond, a, b)`,
    never `table[depth]` or `int(depth)`, which would wait for the device.
    For the same reason every value of the instance a hook reads comes
    from `data(device)`, not from a Python attribute.
"""

import argparse

import numpy as np
import torch

import ddo_tpu_torch
from ddo_tpu_torch import FixedWidth, ModelBundle, Problem, Relaxation, StateRanking
from ddo_tpu_torch.core.problem import depth_row

I32 = torch.int32


# ---------------------------------------------------------------------------
# 1. The DP model
# ---------------------------------------------------------------------------
class IntervalScheduling(Problem):
    """Jobs i have [start_i, end_i) and profit_i; keep a non-overlapping
    subset of maximum profit.

    DP: process jobs by increasing start time; the state is the earliest
    time the machine is free.  Decision 1 takes the job (valid iff it
    starts after the machine is free), 0 skips it.
    """

    name = "interval"
    domain_size = 2  # {skip, take}

    def __init__(self, start, end, profit):
        order = np.argsort(start, kind="stable")
        self.start = np.asarray(start)[order].astype(np.int32)
        self.end = np.asarray(end)[order].astype(np.int32)
        self.profit = np.asarray(profit)[order].astype(np.int32)
        self.nb_variables = len(self.start)
        # suffix sums of profit: RUB data (computed once, lives in `data`)
        self.suffix = np.concatenate(
            [np.cumsum(self.profit[::-1])[::-1], [0]]
        ).astype(np.int32)
        self._data = {}

    def data(self, device):
        # everything the hooks need, as tensors on the compiler's device,
        # built once per device
        device = torch.device(device)
        if device not in self._data:
            t = lambda a: torch.as_tensor(a, dtype=I32, device=device)
            self._data[device] = dict(start=t(self.start), end=t(self.end),
                                      profit=t(self.profit), suffix=t(self.suffix))
        return self._data[device]

    def initial_state(self):
        # the root on the host: numpy, no batch dimension
        return dict(free=np.asarray(0, np.int32))

    def step(self, data, states, var, depth):
        """Expand both domain slots of B states at once.

        `states["free"]` is [B], `var` int64 [B] the job each row branches
        on.  Returns (next_states [B, D], cost int32 [B, D], decision
        value int32 [B, D], valid bool [B, D]).
        """
        free = states["free"][:, None]                      # [B, 1]
        take = torch.arange(self.domain_size, device=free.device) == 1  # [D]
        can_take = free <= data["start"][var][:, None]      # [B, 1]
        next_free = torch.where(take, data["end"][var][:, None], free)
        cost = torch.where(take, data["profit"][var][:, None], 0).to(I32)
        valid = torch.where(take, can_take, True)
        dval = take.to(I32).expand_as(valid)
        return dict(free=next_free.to(I32)), cost, dval, valid

    # static branching order: job 0, 1, 2, ... (by start time), the
    # default `var_order`.  Return None from var_order and implement
    # next_variable(data, depth, states, mask, assigned) instead for
    # data-dependent orders, one variable per lane (see models/misp.py).

    def pack(self, states):
        # canonical int32 key columns [B, k] for duplicate detection; the
        # default would work too (shown here for completeness)
        return states["free"].reshape(-1, 1)


# ---------------------------------------------------------------------------
# 2. The relaxation
# ---------------------------------------------------------------------------
class IntervalRelax(Relaxation):
    """Merging states = taking the *earliest* free time.

    The merged state can do anything any merged-away state could (a machine
    free earlier accepts a superset of the remaining jobs), so the relaxed
    DD's best value upper-bounds the true optimum: the admissibility
    requirement of Relaxation::merge (dp.rs:84-92).
    """

    def __init__(self, pb):
        self.pb = pb

    def data(self, device):
        # each hook family gets its OWN data: Problem.step sees
        # Problem.data(device), Relaxation.merge/rub see this
        return dict(suffix=self.pb.data(device)["suffix"])

    def merge(self, data, states, mask):
        # states["free"] [B, C], mask [B, C]: one merged state per row
        free = torch.where(mask, states["free"], torch.iinfo(torch.int32).max)
        return dict(free=free.amin(dim=1).to(I32))

    def rub(self, data, states, depth):
        # can never gain more than every remaining profit: int32 [B]
        return depth_row(data["suffix"], depth).repeat(states["free"].shape[0])


# ---------------------------------------------------------------------------
# 3. The ranking
# ---------------------------------------------------------------------------
class IntervalRanking(StateRanking):
    """Greater is better: a machine free earlier is more promising."""

    def score(self, data, states):
        # int32 [B, R] compared lexicographically; here R = 1
        return -states["free"].reshape(-1, 1)


# ---------------------------------------------------------------------------
# Solve + verify
# ---------------------------------------------------------------------------
def brute_force(start, end, profit):
    n = len(start)
    best = 0
    for m in range(1 << n):
        sel = [i for i in range(n) if m >> i & 1]
        ok = all(
            end[a] <= start[b] or end[b] <= start[a]
            for i, a in enumerate(sel)
            for b in sel[i + 1:]
        )
        if ok:
            best = max(best, sum(profit[i] for i in sel))
    return best


def instance():
    """The JAX tutorial's instance: 14 jobs from `default_rng(7)`."""
    rng = np.random.default_rng(7)
    n = 14
    start = rng.integers(0, 80, n)
    length = rng.integers(3, 25, n)
    end = start + length
    profit = rng.integers(1, 40, n)
    return start, end, profit


def main(device="cuda"):
    """Solve the instance on `device` ("cuda", the card, or "cpu", the
    plain PyTorch route; no fallback from one to the other) and check it
    against brute force.  Returns the solver."""
    start, end, profit = instance()
    n = len(start)
    pb = IntervalScheduling(start, end, profit)
    bundle = ModelBundle(pb, IntervalRelax(pb), IntervalRanking())

    # assemble a solver exactly like a reference example main.rs: width
    # heuristic + threshold cache + cutset choice; batch>1 compiles several
    # open subproblems per superstep (one K-lane pass on the device)
    solver = ddo_tpu_torch.SequentialSolver(
        bundle,
        width_heu=FixedWidth(4),
        cache=ddo_tpu_torch.SimpleCache(),
        cutset_type=ddo_tpu_torch.FRONTIER,
        batch=4,
        device=device,
    )
    completion = solver.maximize()

    vals, pset = solver.best_solution()
    chosen = [i for i in range(n) if pset[i] and vals[i] == 1]
    print(f"proved optimal: {completion.is_exact}")
    print(f"best profit:    {solver.best_value()}")
    print(f"jobs taken:     {chosen}")
    print(f"explored:       {solver.explored()} subproblems, gap {solver.gap()}")

    expected = brute_force(start.tolist(), end.tolist(), profit.tolist())
    assert solver.best_value() == expected, (solver.best_value(), expected)
    print(f"brute force agrees: {expected}")

    # bonus: export one relaxed DD as graphviz (visualisation/main.rs analogue)
    from ddo_tpu_torch.core.types import CompilationType, CutsetType, root_subproblem
    from ddo_tpu_torch.engine.mdd import DDCompiler
    from ddo_tpu_torch.engine.viz import VizConfig, as_graphviz

    dd = DDCompiler(bundle, width=8, cutset_type=CutsetType.FRONTIER,
                    device=device).compile(
        CompilationType.RELAXED, root_subproblem(pb), best_lb=-(10**9), eff_width=3
    )
    dot = as_graphviz(dd, VizConfig(show_value=True, show_rub=True))
    print(f"\ngraphviz export: {len(dot.splitlines())} lines (pipe to `dot -Tsvg`)")
    return solver


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Weighted interval scheduling on ddo_tpu_torch.")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch route on the CPU instead of the card")
    main("cpu" if ap.parse_args().cpu else "cuda")
