"""One-call API: counterpart of `ddo_tpu/api.py` and of the reference's
Python bindings (`py_ddo/src/lib.rs:46-98`), whose surface is a single
`maximize(...)` returning a `Solution` record."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from ddo_tpu_torch.core.heuristics import FixedWidth, NbUnassignedWidth, NoCutoff, TimeBudget
from ddo_tpu_torch.core.problem import ModelBundle
from ddo_tpu_torch.core.types import CutsetType
from ddo_tpu_torch.search.cache import EmptyCache, SimpleCache
from ddo_tpu_torch.search.fringe import NoDupFringe, SimpleFringe
from ddo_tpu_torch.search.solver import SequentialSolver


@dataclasses.dataclass
class Solution:
    """py_ddo's Solution record (lib.rs:20-44)."""

    aborted: bool
    objective: Optional[int]
    upper_bound: int
    lower_bound: int
    assignment: Optional[List[int]]
    gap: float
    duration: float


def maximize(
    problem,
    relax,
    ranking,
    lel: bool = True,
    use_cache: bool = True,
    dedup: bool = True,
    width: Optional[int] = None,
    timeout: Optional[float] = None,
    batch: int = 1,
    dominance=None,
    *,
    device="cuda",
) -> Solution:
    """Solve `problem` to proved optimality (or until `timeout` seconds).

    Mirrors `py_ddo.maximize` (lib.rs:46-98): `lel` picks the
    last-exact-layer vs frontier cutset, `use_cache` the threshold cache,
    `dedup` the no-duplicate fringe, `width` a FixedWidth override
    (default: number of unassigned variables, lib.rs:138-146).  `batch`
    is how many subproblems one superstep compiles, `device` where:
    "cuda" (the default) runs the kernels and raises without a card,
    "cpu" runs the plain versions.
    """
    solver = SequentialSolver(
        ModelBundle(problem, relax, ranking),
        width_heu=FixedWidth(width) if width
        else NbUnassignedWidth(problem.nb_variables),
        cutset_type=CutsetType.LAST_EXACT_LAYER if lel else CutsetType.FRONTIER,
        cache=SimpleCache() if use_cache else EmptyCache(),
        cutoff=TimeBudget(timeout) if timeout is not None else NoCutoff(),
        fringe=NoDupFringe() if dedup else SimpleFringe(),
        dominance=dominance,
        batch=batch,
        device=device,
    )
    start = time.perf_counter()
    completion = solver.maximize()
    duration = time.perf_counter() - start

    assignment = None
    if solver.best_solution() is not None:
        vals, _ = solver.best_solution()
        assignment = [int(v) for v in vals]

    return Solution(
        aborted=not completion.is_exact,
        objective=solver.best_value(),
        upper_bound=solver.best_upper_bound(),
        lower_bound=solver.best_lower_bound(),
        assignment=assignment,
        gap=solver.gap(),
        duration=duration,
    )
