"""Barrier cache: per-(state, depth) pruning thresholds.

Counterpart of `ddo_tpu/search/cache.py` (reference: the `Cache` trait,
abstraction/cache.rs:27-55, `SimpleCache`, implementation/cache/simple.rs,
and `EmptyCache`, cache/empty.rs).  Keys are the canonical packed-state
key columns the engine produces, so lookups are exact-state equality.

Two surfaces:
  * exact lookups (`must_explore`) used when popping subproblems
    (sequential.rs:341-343);
  * bounded per-depth tables (`snapshot`) sent to the compile device so the
    engine prunes at-or-below-threshold nodes inside a compilation
    (_filter_with_cache, clean.rs:710-726).  Dropping entries only weakens
    pruning (sound); duplicate rows resolve to the max threshold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ddo_tpu_torch.core.types import SubProblem, Threshold, host_pack

#: rows of every snapshot table per depth (the strongest thresholds)
TABLE_ROWS = 256


def tables_to_device(tab, device):
    """Filter tables (a dict of numpy arrays, as `snapshot` builds and as
    ddo_tpu's snapshots are) as torch tensors on `device`; None stays None."""
    if tab is None:
        return None
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in tab.items()}


class Cache:
    def initialize(self, problem):
        pass

    def get_threshold(self, key: bytes, depth: int) -> Optional[Threshold]:
        return None

    def update_threshold(self, key: bytes, depth: int, value: int, explored: bool):
        pass

    def update_batch(self, depths, keys_cols, thetas, explored):
        pass

    def snapshot(self, device):
        """Filter tables on `device`, or None (no filtering)."""
        return None

    def clear_layer(self, depth: int):
        pass

    def clear(self):
        pass

    def must_explore(self, sub: SubProblem) -> bool:
        """Default rule from abstraction/cache.rs:32-39."""
        th = self.get_threshold(sub.key, sub.depth)
        if th is None:
            return True
        return sub.value > th.value or (sub.value == th.value and not th.explored)


class EmptyCache(Cache):
    """No-op cache (cache/empty.rs)."""


class SimpleCache(Cache):
    """Per-depth threshold store (cache/simple.rs:36-74).

    Records live in bounded per-depth numpy arrays (duplicate rows allowed;
    lookups take the lexicographic max of (value, explored), which is the
    reference's monotone `better_of` rule).  Capacity eviction drops the
    weakest thresholds: weaker pruning, never wrong."""

    #: per-depth array capacity (snapshot tables select the top TABLE_ROWS)
    TABLE_CAP = 2048

    def __init__(self):
        self._keys = []  # per depth: np.int32 [cap, K] (lazy)
        self._vals = []  # per depth: np.int32 [cap]
        self._expl = []  # per depth: np.uint8 [cap]
        self._count = []
        self._tables = None  # built numpy tables (invalidated on write)
        self._dev_tables = {}  # device -> tensors of `_tables`
        self._key_width = None

    def initialize(self, problem):
        n = problem.nb_variables
        self._keys = [None] * (n + 1)
        self._vals = [None] * (n + 1)
        self._expl = [None] * (n + 1)
        self._count = [0] * (n + 1)
        self._invalidate()
        # key width, so snapshot() serves all-invalid tables before the
        # first insertion
        self._key_width = int(host_pack(problem, problem.initial_state()).shape[0])

    def _invalidate(self):
        self._tables = None
        self._dev_tables = {}

    @staticmethod
    def _key_row(key: bytes):
        """bytes -> int32 row (keys are fixed width within one problem)."""
        if len(key) % 4:
            key = key + b"\0" * (4 - len(key) % 4)
        return np.frombuffer(key, np.int32)

    def get_threshold(self, key, depth):
        if depth >= len(self._count) or self._count[depth] == 0:
            return None
        cnt = self._count[depth]
        row = self._key_row(key)
        if self._keys[depth].shape[1] != row.shape[0]:
            return None
        hit = np.all(self._keys[depth][:cnt] == row[None, :], axis=1)
        if not hit.any():
            return None
        vals = self._vals[depth][:cnt][hit]
        expl = self._expl[depth][:cnt][hit]
        best = np.lexsort((expl, vals))[-1]  # max (value, explored)
        return Threshold(int(vals[best]), bool(expl[best]))

    def update_threshold(self, key, depth, value, explored):
        # monotone max update (cache/simple.rs:62-66): appending a row and
        # taking the per-key max at lookup is equivalent
        self._invalidate()
        self._append_rows(depth, self._key_row(key).reshape(1, -1),
                          np.asarray([value], np.int32),
                          np.asarray([explored], np.uint8))

    def update_batch(self, depths, keys_cols, thetas, explored):
        """Vectorized absorption of one compiled DD's threshold records
        ((depth, key_cols, theta, explored) rows from CompiledDD.cache_batch)."""
        if len(depths) == 0:
            return
        self._invalidate()
        keys_cols = np.ascontiguousarray(keys_cols, np.int32)
        order = np.argsort(depths, kind="stable")
        ds = np.asarray(depths)[order]
        ks = keys_cols[order]
        ts = np.asarray(thetas, np.int32)[order]
        ex = np.asarray(explored, np.uint8)[order]
        starts = np.flatnonzero(np.diff(ds, prepend=-1))
        for s, e in zip(starts, list(starts[1:]) + [len(ds)]):
            self._append_rows(int(ds[s]), ks[s:e], ts[s:e], ex[s:e])

    def _append_rows(self, d, rows, vals, expl):
        K = rows.shape[1]
        cap = self.TABLE_CAP
        if self._keys[d] is None:
            self._keys[d] = np.zeros((cap, K), np.int32)
            self._vals[d] = np.zeros(cap, np.int32)
            self._expl[d] = np.zeros(cap, np.uint8)
        cnt = self._count[d]
        m = len(rows)
        if m > cap // 2:  # one giant batch: keep its strongest rows
            sel = np.argpartition(-vals, cap // 2 - 1)[: cap // 2]
            rows, vals, expl = rows[sel], vals[sel], expl[sel]
            m = len(rows)
        if cnt + m > cap:
            # keep the strongest thresholds (drop = weaker pruning, sound)
            allk = np.concatenate([self._keys[d][:cnt], rows])
            allv = np.concatenate([self._vals[d][:cnt], vals])
            alle = np.concatenate([self._expl[d][:cnt], expl])
            keep = np.argpartition(-allv, cap // 2)[: cap // 2]
            self._keys[d][: len(keep)] = allk[keep]
            self._vals[d][: len(keep)] = allv[keep]
            self._expl[d][: len(keep)] = alle[keep]
            self._count[d] = len(keep)
            return
        self._keys[d][cnt : cnt + m] = rows
        self._vals[d][cnt : cnt + m] = vals
        self._expl[d][cnt : cnt + m] = expl
        self._count[d] = cnt + m

    def tables(self):
        """[n+1, T, K] numpy filter tables: the TABLE_ROWS strongest
        thresholds per depth."""
        if self._tables is not None:
            return self._tables
        n1 = len(self._count)
        K = next((k.shape[1] for k in self._keys if k is not None), self._key_width)
        keys = np.zeros((n1, TABLE_ROWS, K), np.int32)
        vals = np.zeros((n1, TABLE_ROWS), np.int32)
        valid = np.zeros((n1, TABLE_ROWS), bool)
        for d in range(n1):
            c = self._count[d]
            if c == 0:
                continue
            if c > TABLE_ROWS:
                sel = np.argpartition(-self._vals[d][:c], TABLE_ROWS - 1)[:TABLE_ROWS]
            else:
                sel = np.arange(c)
            m = len(sel)
            keys[d, :m] = self._keys[d][sel]
            vals[d, :m] = self._vals[d][sel]
            valid[d, :m] = True
        self._tables = dict(keys=keys, vals=vals, valid=valid)
        return self._tables

    def snapshot(self, device):
        """The filter tables as tensors on `device` (one copy per write)."""
        device = torch.device(device)
        if device not in self._dev_tables:
            self._dev_tables[device] = tables_to_device(self.tables(), device)
        return self._dev_tables[device]

    def clear_layer(self, depth):
        if depth < len(self._count):
            self._count[depth] = 0
            self._invalidate()

    def clear(self):
        self._count = [0] * len(self._count)
        self._invalidate()
