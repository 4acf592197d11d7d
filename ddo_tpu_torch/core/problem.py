"""Batch-first DP-model contract: counterpart of `ddo_tpu/core/problem.py`.

Reference semantics: the `Problem`, `Relaxation` and `StateRanking` traits
(ddo/src/abstraction/dp.rs:34-107, heuristics.rs:74) and `Dominance`
(abstraction/dominance.rs:37-99).

ddo_tpu writes each hook for ONE state and lets the engine `vmap` it.
Here every device hook takes a leading batch dimension B instead: the
engine flattens its K lanes x W rows (or x W*D candidates) into B and
calls each hook once per layer.  A device state is a dict of tensors
[B, ...] (or one tensor [B, ...]); a host state is the same structure of
numpy arrays without the batch dimension.

Every device hook receives the model's `data` explicitly: the dict of
instance tensors that `data(device)` built on the compiler's device.
Every value of the instance a hook reads comes from there: the engine
replays one compile's layers, hooks included, for every instance of the
same shapes (engine/mdd.py), so a value read from a Python attribute
would stay the first instance's.  The shapes (n, the domain size, the
state's widths) may come from attributes.

A hook that takes `depth` (`step`, `next_variable`, `Relaxation.rub`)
gets it as a Python int or, from the engine, as an int64 0-d tensor on
the device.  Read it with `depth_row` and `depth_select`, or in
arithmetic; never as an index or through `int()`, which would wait for
the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ddo_tpu_torch.core.types import state_leaves
from ddo_tpu_torch.utils.num import INF, VALUE_DTYPE


def depth_row(table, depth):
    """`table[depth]` for a depth given as a Python int or as an int64
    0-d tensor on the device, without reading the tensor on the host
    (indexing with a 0-d tensor would)."""
    if torch.is_tensor(depth):
        return table.index_select(0, depth.reshape(1)).squeeze(0)
    return table[depth]


def depth_select(cond, a, b):
    """`a if cond else b` for a condition on the depth: a Python bool, or
    a 0-d bool tensor on the device, which selects elementwise."""
    return torch.where(cond, a, b) if torch.is_tensor(cond) else (a if cond else b)


class Problem:
    """DP formulation of a maximization problem as a labeled transition
    system (dp.rs:34-71), with the iteration inverted for dense batching:
    one fused `step` expands every domain slot of B states at once."""

    #: short name used by the registry
    name: str = "problem"
    #: number of decision variables
    nb_variables: int = 0
    #: maximum number of domain values of any variable
    domain_size: int = 0

    def data(self, device):
        """Instance tensors on `device`, passed to every device hook."""
        return ()

    # -- state space ---------------------------------------------------------
    def initial_state(self):
        """The root state on the host (dict of numpy arrays)."""
        raise NotImplementedError

    def initial_value(self) -> int:
        return 0

    def step(self, data, states, var, depth):
        """Expand every domain slot of B states.

        `states` [B, ...], `var` int64[B] the branched variable of each
        row, `depth` the layer index (see the module notes).  Returns
        `(next_states [B, D, ...], cost int32[B, D], dval int32[B, D],
        valid bool[B, D])`;
        `valid=False` marks slots outside the domain of `var`."""
        raise NotImplementedError

    # -- variable ordering ---------------------------------------------------
    def var_order(self):
        """Static branching order: host int32[n] permutation, or None when
        the order is dynamic (`next_variable`)."""
        return np.arange(self.nb_variables, dtype=np.int32)

    def next_variable(self, data, depth, states, mask, assigned):
        """Dynamic branching hook (used when `var_order` returns None).

        `states` [K, W, ...] and `mask` bool[K, W] describe the layer each
        of the K lanes is about to expand, `assigned` bool[K, n] the
        variables each lane has branched on already.  Returns int64[K]:
        one unassigned variable per lane."""
        raise NotImplementedError

    # -- long arcs -----------------------------------------------------------
    def is_impacted_by(self, data, states, var):
        """Long-arc hook (dp.rs:66-71, pooled.rs:608-680): `states`
        [B, ...], `var` int64[B]; False means branching `var` does not
        impact the state.  When a model overrides this, the engine runs in
        long-arc mode: an unimpacted node crosses the layer through one
        zero-cost identity arc whose decision is never recorded on the
        path.  Not overridden, every variable impacts every state and the
        engine skips the extra work."""
        return torch.ones(var.shape, dtype=torch.bool, device=var.device)

    # -- dedup key -----------------------------------------------------------
    def pack(self, states):
        """Canonical key columns int32[B, K] identifying each state.

        The default flattens every leaf (dict values by sorted key, like
        ddo_tpu's pytree order); override for a tighter packing."""
        return torch.cat([l.reshape(l.shape[0], -1).to(torch.int32)
                          for l in state_leaves(states)], dim=1)

    def unpack(self, cols):
        """Inverse of the default `pack` on the host: int32[K] -> state,
        split along the leaves of `initial_state`."""
        template = self.initial_state()
        cols = np.asarray(cols)
        if isinstance(template, dict):
            out, k = {}, 0
            for name in sorted(template):
                shape = np.shape(template[name])
                size = int(np.prod(shape)) if shape else 1
                dtype = np.asarray(template[name]).dtype
                chunk = cols[k : k + size].astype(dtype)
                out[name] = chunk.reshape(shape) if shape else chunk[0]
                k += size
            return out
        shape = np.shape(template)
        chunk = cols[: int(np.prod(shape)) if shape else 1]
        chunk = chunk.astype(np.asarray(template).dtype)
        return chunk.reshape(shape) if shape else chunk[0]


class Relaxation:
    """Node merge, arc relaxation and rough upper bound (dp.rs:77-107)."""

    def data(self, device):
        return ()

    def merge(self, data, states, mask):
        """Merge the rows selected by `mask` [B, C] of `states` [B, C, ...]
        into one state per batch row: returns states [B, ...]."""
        raise NotImplementedError

    def relax_cost(self, data, src, dst, merged, dval, cost, var):
        """Cost of arcs redirected to the merged node, all [B] (default:
        unchanged)."""
        return cost

    def rub(self, data, states, depth):
        """Rough upper bound int32[B] of each state's remaining value."""
        B = state_leaves(states)[0].shape[0]
        return torch.full((B,), INF, dtype=VALUE_DTYPE,
                          device=state_leaves(states)[0].device)


class StateRanking:
    """Orders states by how promising they are (heuristics.rs:74): a score
    int32[B, R] compared lexicographically, larger is better."""

    def data(self, device):
        return ()

    def score(self, data, states):
        leaf = state_leaves(states)[0]
        return torch.zeros((leaf.shape[0], 1), dtype=torch.int32,
                           device=leaf.device)


class Dominance:
    """Keyed multi-dimensional dominance between same-depth states
    (dominance.rs:37-99).

    `key_cols(states)` int32[B, KK]: states are comparable only when every
    key column matches (KK may be 0), or None when the model does not
    support filtering.  `coord_cols(states)` int32[B, CC]: greater is
    better on every axis.  `use_value` adds the node value as the last
    dimension and enables pruning thresholds (dominance.rs:57-79)."""

    use_value: bool = False

    def key_cols(self, states):
        return None

    def coord_cols(self, states):
        leaf = state_leaves(states)[0]
        return torch.zeros((leaf.shape[0], 0), dtype=torch.int32,
                           device=leaf.device)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Problem + relaxation + ranking, the static part of a compilation
    (the reference's `CompilationInput` statics, abstraction/mdd.rs:51-71)."""

    problem: Problem
    relaxation: Relaxation
    ranking: StateRanking

    def datas(self, device):
        return (self.problem.data(device), self.relaxation.data(device),
                self.ranking.data(device))
