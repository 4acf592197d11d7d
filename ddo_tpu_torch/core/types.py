"""Host-side value types crossing every layer of the framework.

Counterpart of `ddo_tpu/core/types.py` (reference: ddo/src/common.rs).
A state is a dict of numpy arrays (or one bare array) on the host and a
dict of torch tensors with a leading batch dimension on the device; a
solution is a dense int32[n] array of decided values plus a bool[n] mask.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np
import torch

from ddo_tpu_torch.utils.num import INF


class CompilationType(enum.Enum):
    """Mirrors reference `CompilationType` (abstraction/mdd.rs:41-48)."""

    EXACT = 0
    RELAXED = 1
    RESTRICTED = 2


class CutsetType(enum.IntEnum):
    """Mirrors reference cutset consts (abstraction/mdd.rs:24-28)."""

    LAST_EXACT_LAYER = 1
    FRONTIER = 2


class Reason(enum.Enum):
    """Mirrors reference `Reason` (common.rs:108-111)."""

    CUTOFF_OCCURRED = 0


@dataclasses.dataclass
class Completion:
    """Outcome of a DD development / solver run (common.rs:115-121)."""

    is_exact: bool
    best_value: Optional[int]


@dataclasses.dataclass(frozen=True)
class Threshold:
    """Barrier-pruning threshold for one (state, depth) (common.rs:96-101)."""

    value: int
    explored: bool

    def better_of(self, other: "Threshold") -> "Threshold":
        """Monotone max used by the cache (cache/simple.rs:62-66)."""
        if (other.value, other.explored) > (self.value, self.explored):
            return other
        return self


@dataclasses.dataclass
class SubProblem:
    """A residual problem rooted at an exact cutset node (common.rs:75-87)."""

    state: Any  # dict of numpy arrays (single state)
    value: int
    path_vals: np.ndarray  # int32[n] decided value per variable
    path_set: np.ndarray  # bool[n] which variables the path decides
    ub: int
    depth: int
    key: bytes = b""  # canonical state key (packed int32 columns)
    #: dominance key/coord columns captured from the compiled planes at
    #: enqueue time; None = evaluate the hooks
    dom_key: Optional[np.ndarray] = None
    dom_coords: Optional[np.ndarray] = None

    def solution_values(self) -> np.ndarray:
        return np.asarray(self.path_vals, dtype=np.int64)


def state_leaves(state):
    """Leaves of a state in ddo_tpu's pytree order: a dict's values by
    sorted key, or the state itself when it is one array."""
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    return [state]


def host_batch(state):
    """One host state as a device-hook batch of one (CPU tensors)."""
    if isinstance(state, dict):
        return {k: torch.as_tensor(np.asarray(v))[None] for k, v in state.items()}
    return torch.as_tensor(np.asarray(state))[None]


def host_pack(problem, state) -> np.ndarray:
    """`problem.pack` of one host state: int32[K] numpy key columns."""
    return np.asarray(problem.pack(host_batch(state))[0].numpy(), np.int32)


def root_subproblem(problem) -> SubProblem:
    """Builds the root subproblem (sequential.rs:315-323).

    The canonical subproblem key is the engine's packed int32 key columns
    (`problem.pack`), so fringe dedup and the barrier cache agree with the
    keys the compiled planes carry."""
    n = problem.nb_variables
    state = problem.initial_state()
    return SubProblem(
        state=state,
        value=int(problem.initial_value()),
        path_vals=np.zeros(n, np.int32),
        path_set=np.zeros(n, bool),
        ub=INF,
        depth=0,
        key=host_pack(problem, state).tobytes(),
    )


def state_key_bytes(state) -> bytes:
    """Canonical bytes of a single host-side state (dedup key)."""
    return b"|".join(
        np.ascontiguousarray(np.asarray(l, np.int64)).tobytes()
        for l in state_leaves(state)
    )
