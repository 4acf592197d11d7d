"""Search heuristics: maximum width policies and cutoffs.

Counterpart of `ddo_tpu/core/heuristics.py` (reference:
ddo/src/implementation/heuristics/):
  * `FixedWidth` (width.rs:166), `NbUnassignedWidth` (width.rs:397),
    decorators `Times` (width.rs:636) and `DivBy` (width.rs:875);
  * `NoCutoff` (cutoff.rs:160) and `TimeBudget` (cutoff.rs:302) — the
    reference spawns a timer thread flipping an AtomicBool; here a
    monotonic-clock check suffices since the solver polls between
    supersteps (and between layer chunks of a chunked compile).

The engine takes each lane's effective width as a tensor over a fixed
buffer, so width heuristics are plain host functions evaluated per
subproblem.
"""

from __future__ import annotations

import time

from ddo_tpu_torch.core.types import SubProblem


class WidthHeuristic:
    """abstraction/heuristics.rs:61 — max layer width for a subproblem."""

    def max_width(self, sub: SubProblem) -> int:
        raise NotImplementedError


class FixedWidth(WidthHeuristic):
    def __init__(self, width: int):
        self.width = width

    def max_width(self, sub):
        return self.width


class NbUnassignedWidth(WidthHeuristic):
    """Width = number of unassigned variables (width.rs:397)."""

    def __init__(self, nb_variables: int):
        self.nb_variables = nb_variables

    def max_width(self, sub):
        return max(1, self.nb_variables - int(sub.path_set.sum()))


class Times(WidthHeuristic):
    """`factor` times the inner heuristic's width (width.rs:636)."""

    def __init__(self, factor: int, inner: WidthHeuristic):
        self.factor = factor
        self.inner = inner

    def max_width(self, sub):
        return self.factor * self.inner.max_width(sub)


class DivBy(WidthHeuristic):
    """The inner heuristic's width divided by `divisor`, at least 1
    (width.rs:875)."""

    def __init__(self, divisor: int, inner: WidthHeuristic):
        self.divisor = divisor
        self.inner = inner

    def max_width(self, sub):
        return max(1, self.inner.max_width(sub) // self.divisor)


class Cutoff:
    """abstraction/heuristics.rs:102."""

    def must_stop(self) -> bool:
        return False


class NoCutoff(Cutoff):
    pass


class TimeBudget(Cutoff):
    """Stop after a wall-clock budget in seconds (cutoff.rs:302-343)."""

    def __init__(self, seconds: float):
        self.deadline = time.monotonic() + seconds

    def must_stop(self):
        return time.monotonic() >= self.deadline
