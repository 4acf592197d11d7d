"""Pairwise state-dominance pruning across the whole search.

Counterpart of `ddo_tpu/search/dominance.py` (reference: the `Dominance`
trait incl. `partial_cmp`, abstraction/dominance.rs:37-99;
`SimpleDominanceChecker`, implementation/dominance/simple.rs:37-116;
`EmptyDominanceChecker`, dominance/empty.rs).

Store: per depth, an append-only array of (key_cols, coord_cols, value)
rows with capacity-bounded keep-top-by-value compaction.  The reference
evicts entries dominated by newer ones (simple.rs:95-97); keeping stale
entries is sound by transitivity, and dropping rows at compaction only
weakens pruning.  The same arrays feed the per-depth `snapshot()` tables
the engine uses for in-compilation dominance filtering (clean.rs:689-708).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ddo_tpu_torch.core.problem import Dominance
from ddo_tpu_torch.core.types import host_batch
from ddo_tpu_torch.search.cache import TABLE_ROWS, tables_to_device


@dataclasses.dataclass
class DominanceCheckResult:
    dominated: bool
    threshold: Optional[int]


class DominanceChecker:
    dom: Optional[Dominance] = None

    def prime(self, problem):
        """Learn the key/coord widths from the root state so `snapshot()`
        can serve all-invalid tables before the first insertion."""

    def clear_layer(self, depth: int):
        pass

    def is_dominated_or_insert(self, state, key_bytes, depth, value) -> DominanceCheckResult:
        return DominanceCheckResult(False, None)

    def is_dominated(self, state, depth, value) -> bool:
        """Check-only probe (no insertion)."""
        return False

    def insert_batch(self, depths, keys, coords, values):
        pass

    def snapshot(self, device):
        return None


class EmptyDominanceChecker(DominanceChecker):
    pass


class SimpleDominanceChecker(DominanceChecker):
    """Keyed per-depth dominance store (simple.rs:37-116) over dense
    (key_cols, coord_cols, value) rows."""

    #: per-depth row capacity (compaction keeps the top half by value)
    STORE_CAP = 4096

    def __init__(self, dominance: Dominance, nb_variables: int):
        self.dom = dominance
        n1 = nb_variables + 1
        self._keys = [None] * n1   # np.int32 [cap, KK]
        self._coords = [None] * n1  # np.int32 [cap, CC]
        self._vals = [None] * n1    # np.int64 [cap]
        self._hash = [None] * n1    # np.int64 [cap], key-row prefilter
        self._count = [0] * n1
        self._tables = None
        self._dev_tables = {}
        self._dims = None  # (KK, CC) once known

    def prime(self, problem):
        kc, cc = self._cols(problem.initial_state())
        if kc is not None:
            self._dims = (kc.shape[0], cc.shape[0])

    def _invalidate(self):
        self._tables = None
        self._dev_tables = {}

    @staticmethod
    def _hash_rows(keys):
        """Deterministic int64 row hash of key columns: probes compare one
        i64 per stored row before the KK-wide compares."""
        k = keys.astype(np.int64).astype(np.uint64)
        mult = (np.arange(k.shape[1], dtype=np.uint64) * np.uint64(2)
                + np.uint64(1)) * np.uint64(0x9E3779B97F4A7C15)
        with np.errstate(over="ignore"):
            return (k * mult[None, :]).sum(axis=1).view(np.int64)

    def _cols(self, state):
        """Host evaluation of the device hooks for a single host state."""
        batch = host_batch(state)
        kc = self.dom.key_cols(batch)
        if kc is None:
            return None, None
        return (np.asarray(kc[0].numpy(), np.int32),
                np.asarray(self.dom.coord_cols(batch)[0].numpy(), np.int32))

    def clear_layer(self, depth):
        self._count[depth] = 0
        self._invalidate()

    def _ensure(self, d, KK, CC):
        if self._keys[d] is None:
            cap = self.STORE_CAP
            self._keys[d] = np.zeros((cap, KK), np.int32)
            self._coords[d] = np.zeros((cap, CC), np.int32)
            self._vals[d] = np.zeros(cap, np.int64)
            self._hash[d] = np.zeros(cap, np.int64)

    def insert_batch(self, depths, keys, coords, values):
        """Bulk insertion (CompiledDD.exact_nodes_batch): mirrors the
        per-layer insertions of _filter_with_dominance (clean.rs:697)."""
        if len(depths) == 0:
            return
        self._invalidate()
        keys = np.atleast_2d(np.asarray(keys, np.int32))
        coords = np.atleast_2d(np.asarray(coords, np.int32))
        values = np.asarray(values, np.int64)
        order = np.argsort(depths, kind="stable")
        ds = np.asarray(depths)[order]
        starts = np.flatnonzero(np.diff(ds, prepend=-1))
        for s, e in zip(starts, list(starts[1:]) + [len(ds)]):
            d = int(ds[s])
            sel = order[s:e]
            self._ensure(d, keys.shape[1], coords.shape[1])
            self._append(d, keys[sel], coords[sel], values[sel])

    def _append(self, d, k, c, v):
        cap = self.STORE_CAP
        cnt = self._count[d]
        m = len(k)
        if m > cap // 2:  # one giant batch: keep its strongest rows
            sel = np.argpartition(-v, cap // 2 - 1)[: cap // 2]
            k, c, v = k[sel], c[sel], v[sel]
            m = len(k)
        if cnt + m > cap:
            keep = np.argpartition(-self._vals[d][:cnt], cap // 2 - 1)[: cap // 2]
            self._keys[d][: len(keep)] = self._keys[d][keep]
            self._coords[d][: len(keep)] = self._coords[d][keep]
            self._vals[d][: len(keep)] = self._vals[d][keep]
            self._hash[d][: len(keep)] = self._hash[d][keep]
            cnt = len(keep)
        self._keys[d][cnt : cnt + m] = k
        self._coords[d][cnt : cnt + m] = c
        self._vals[d][cnt : cnt + m] = v
        self._hash[d][cnt : cnt + m] = self._hash_rows(k)
        self._count[d] = cnt + m

    # ------------------------------------------------------------- checking
    def _dominators(self, d, kcols, ccols, value):
        """Bool mask over stored rows strictly dominating (k, c, value) per
        partial_cmp (dominance.rs:57-79), with the stored values and the
        coordinate-equality mask (only meaningful where dominating)."""
        cnt = self._count[d]
        if cnt == 0:
            return None
        cand = np.flatnonzero(
            self._hash[d][:cnt] == self._hash_rows(kcols[None, :])[0])
        km_out = np.zeros(cnt, bool)
        sv = self._vals[d][:cnt]
        eqc_out = np.zeros(cnt, bool)
        if len(cand) == 0:
            return km_out, sv, eqc_out
        svc = sv[cand]
        km = np.all(self._keys[d][cand] == kcols[None, :], axis=1)
        sc = self._coords[d][cand]
        ge = np.all(sc >= ccols[None, :], axis=1)
        eqc = np.all(sc == ccols[None, :], axis=1)
        if self.dom.use_value:
            dom_c = km & ge & (svc >= value) & ~(eqc & (svc == value))
        else:
            dom_c = km & ge & ~eqc
        km_out[cand] = dom_c
        eqc_out[cand] = eqc
        return km_out, sv, eqc_out

    def is_dominated(self, state, depth, value) -> bool:
        kcols, ccols = self._cols(state)
        if kcols is None:
            return False
        res = self._dominators(depth, kcols, ccols, int(value))
        return res is not None and bool(res[0].any())

    def is_dominated_cols(self, kcols, ccols, depth, value) -> bool:
        """Check-only probe from pre-computed columns (no hook calls)."""
        res = self._dominators(int(depth), np.asarray(kcols, np.int32),
                               np.asarray(ccols, np.int32), int(value))
        return res is not None and bool(res[0].any())

    def is_dominated_batch(self, depths, keys, coords, values):
        """Vectorized check-only probe over row batches: bool[M] mask of
        strictly-dominated rows (no insertion)."""
        out = np.zeros(len(depths), bool)
        keys = np.atleast_2d(np.asarray(keys, np.int32))
        coords = np.atleast_2d(np.asarray(coords, np.int32))
        depths = np.asarray(depths)
        for d in np.unique(depths):
            d = int(d)
            cnt = self._count[d]
            if cnt == 0:
                continue
            rows = np.flatnonzero(depths == d)
            pi, si = np.nonzero(self._hash_rows(keys[rows])[:, None]
                                == self._hash[d][:cnt][None, :])
            if len(pi) == 0:
                continue
            sv = self._vals[d]
            qrows = rows[pi]
            km = np.all(keys[qrows] == self._keys[d][si], axis=1)
            ge = np.all(self._coords[d][si] >= coords[qrows], axis=1)
            eqc = np.all(self._coords[d][si] == coords[qrows], axis=1)
            v = np.asarray(values)[qrows]
            if self.dom.use_value:
                dominates = km & ge & (sv[si] >= v) & ~(eqc & (sv[si] == v))
            else:
                dominates = km & ge & ~eqc
            np.logical_or.at(out, qrows, dominates)
        return out

    def is_dominated_or_insert(self, state, key_bytes, depth, value):
        """simple.rs:71-111 (minus eviction, see the module docstring)."""
        kcols, ccols = self._cols(state)
        if kcols is None:
            return DominanceCheckResult(False, None)
        res = self._dominators(depth, kcols, ccols, int(value))
        if res is not None:
            mask, sv, eqc = res
            if mask.any():
                if self.dom.use_value:
                    thr = int(np.min(np.where(eqc[mask], sv[mask] - 1, sv[mask])))
                    return DominanceCheckResult(True, thr)
                return DominanceCheckResult(True, None)
        self._invalidate()
        self._ensure(depth, len(kcols), len(ccols))
        self._append(depth, kcols[None, :], ccols[None, :],
                     np.asarray([value], np.int64))
        return DominanceCheckResult(False, None)

    # ------------------------------------------------------------- snapshot
    def tables(self):
        """[n+1, T, ...] numpy tables for in-compilation filtering (the
        TABLE_ROWS highest values per depth), or None before the widths
        are known."""
        if self._tables is not None:
            return self._tables
        n1 = len(self._count)
        KK = next((k.shape[1] for k in self._keys if k is not None),
                  self._dims[0] if self._dims else None)
        CC = next((c.shape[1] for c in self._coords if c is not None),
                  self._dims[1] if self._dims else None)
        if KK is None:
            return None
        keys = np.zeros((n1, TABLE_ROWS, KK), np.int32)
        coords = np.zeros((n1, TABLE_ROWS, CC), np.int32)
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
            coords[d, :m] = self._coords[d][sel]
            vals[d, :m] = self._vals[d][sel].astype(np.int32)
            valid[d, :m] = True
        self._tables = dict(keys=keys, coords=coords, vals=vals, valid=valid)
        return self._tables

    def snapshot(self, device):
        """The filter tables as tensors on `device` (one copy per write)."""
        device = torch.device(device)
        if device not in self._dev_tables:
            self._dev_tables[device] = tables_to_device(self.tables(), device)
        return self._dev_tables[device]
