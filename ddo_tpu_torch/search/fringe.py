"""Global branch-and-bound frontier (priority queues of subproblems):
counterpart of `ddo_tpu/search/fringe.py`, host numpy as there.

Host-side counterparts of the reference fringes:
  * `SimpleFringe` (implementation/fringe/simple.rs:27-54): plain max-heap.
  * `NoDupFringe` (implementation/fringe/no_duplicate.rs:52-260): indexed
    heap forbidding two entries with the same state; on duplicate push the
    kept entry gets max(value) / max(ub) and is re-prioritized
    (no_duplicate.rs:88-140).

Ordering follows `MaxUB` (heuristics/subproblem_ranking.rs:76-91): pop in
descending (ub, value, ranking) order — the invariant the solvers rely on
to stop when a popped ub <= best_lb.

The heap lives on the host because it is tiny compared to DD compilation
and inherently sequential.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Optional

import numpy as np

from ddo_tpu_torch.core.types import SubProblem


class Fringe:
    """Abstract fringe (abstraction/fringe.rs:26-44)."""

    def push(self, sub: SubProblem):
        raise NotImplementedError

    def pop(self) -> Optional[SubProblem]:
        raise NotImplementedError

    def clear(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def is_empty(self) -> bool:
        return len(self) == 0


class SubProblemRanking:
    """Order in which the fringe yields open subproblems — counterpart of
    the reference `SubProblemRanking` trait (abstraction/heuristics.rs:88,
    subproblem_ranking.rs).  `key(sub)` returns a comparable; LARGER keys
    pop first (the solvers' descending-UB invariant is only guaranteed when
    the key leads with `sub.ub`, as `MaxUB` does)."""

    def key(self, sub: SubProblem):
        raise NotImplementedError


class MaxUB(SubProblemRanking):
    """Order by (ub, value, state ranking) — subproblem_ranking.rs:76-91."""

    def __init__(self, state_ranking=None):
        self.state_ranking = state_ranking

    def key(self, sub: SubProblem):
        score = (
            self.state_ranking.score_host(sub.state)
            if self.state_ranking is not None
            else 0
        )
        if isinstance(score, np.ndarray):
            score = tuple(int(x) for x in score)
        return (sub.ub, sub.value, score)


def _as_ranking(ranking) -> SubProblemRanking:
    """Back-compat shim: a StateRanking (with `score_host`) becomes the
    tie-break dimension of the default MaxUB order."""
    if ranking is None or isinstance(ranking, SubProblemRanking):
        return ranking or MaxUB()
    return MaxUB(ranking)


def _rank_tuple(ranking: SubProblemRanking, sub: SubProblem):
    """Heap key, negated for Python's min-heap (largest key pops first)."""
    return _neg(ranking.key(sub))


def _neg(score):
    if isinstance(score, tuple):
        return tuple(_neg(s) for s in score)
    return -int(score)


class SimpleFringe(Fringe):
    """Plain binary heap, duplicates allowed (fringe/simple.rs)."""

    def __init__(self, ranking=None):
        self.ranking = _as_ranking(ranking)
        self._heap = []
        self._count = itertools.count()

    def push(self, sub: SubProblem):
        heapq.heappush(self._heap, (_rank_tuple(self.ranking, sub), next(self._count), sub))

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def clear(self):
        self._heap.clear()

    def __len__(self):
        return len(self._heap)


class NoDupFringe(Fringe):
    """State-deduplicated heap (fringe/no_duplicate.rs:52-260).

    Duplicate-push merge rule (no_duplicate.rs:96-117): the stored entry's
    ub becomes max(old, new); if the new node has a strictly longer path
    value its payload replaces the old one; priority is refreshed.
    Implemented with lazy deletion (stale heap entries are skipped on pop).
    """

    def __init__(self, ranking=None):
        self.ranking = _as_ranking(ranking)
        self._heap = []
        self._by_state = {}  # key -> SubProblem (live entry)
        self._count = itertools.count()

    def push(self, sub: SubProblem):
        key = (sub.depth, sub.key)
        cur = self._by_state.get(key)
        if cur is not None:
            # merge rule from no_duplicate.rs:96-117; a *new* object is
            # stored so that older heap tuples become stale (lazy deletion)
            keep = sub if sub.value > cur.value else cur
            keep = SubProblem(
                state=keep.state, value=keep.value, path_vals=keep.path_vals,
                path_set=keep.path_set, ub=max(cur.ub, sub.ub), depth=keep.depth,
                key=keep.key,
            )
            self._by_state[key] = keep
            heapq.heappush(
                self._heap, (_rank_tuple(self.ranking, keep), next(self._count), key, keep)
            )
        else:
            self._by_state[key] = sub
            heapq.heappush(
                self._heap, (_rank_tuple(self.ranking, sub), next(self._count), key, sub)
            )

    def pop(self):
        while self._heap:
            _, _, key, sub = heapq.heappop(self._heap)
            live = self._by_state.get(key)
            if live is sub:
                del self._by_state[key]
                return sub
            # stale entry (superseded by a later push): skip
        return None

    def clear(self):
        self._heap.clear()
        self._by_state.clear()

    def __len__(self):
        return len(self._by_state)
