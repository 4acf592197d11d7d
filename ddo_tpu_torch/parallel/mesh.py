"""Frontier parallelism over a mesh of devices: counterpart of
`ddo_tpu/parallel/mesh.py`.

The reference's only parallelism is a shared-memory thread pool racing on
a mutex-guarded fringe (parallel.rs:287-653).  ddo_tpu replaces it with
data parallelism over the frontier batch: pop K subproblems, shard the K
lanes across a `jax.sharding.Mesh`, and let XLA insert the cross-device
reductions.  PyTorch has no SPMD partitioner, so `MeshCompiler` does that
part itself:

  reference mechanism                  | here
  -------------------------------------+----------------------------------
  thread-private DD compile            | one lane of a shard's K-lane
                                       | `compile_lanes` on its device
  shared best_lb under a Mutex         | max over the gathered lanes,
                                       | masked by `actives`, taken
                                       | between the restricted and the
                                       | relaxed pass (`compile_fused`)
  Condvar starvation/termination       | host checks fringe emptiness
  per-thread upper_bounds vector       | per-lane ub, reduced with max
  work stealing / rebalancing          | the host fringe re-deals the K
                                       | best subproblems every superstep

A compile pads the lane count to a multiple of the mesh size with
duplicates of lane 0 (effective width 1, inactive), splits the lanes into
contiguous shards, runs shard j on mesh device j with that device's
instance tensors and its own copy of the filter tables, and gathers every
plane onto the mesh's first device in lane order.  Every shard starts its
layer loop at the whole batch's minimum root depth, so each lane's planes
are bit-equal to `DDCompiler`'s on the same batch.  Padded lanes stay in
the gathered planes (as in ddo_tpu) but out of the reductions, the
solver's row extraction (`CompiledBatch.actives`) and the per-lane views.

Shards run one after another from one host thread; on a card the work of
one shard is queued before the next starts, and nothing waits on the
device between shards except a chunked compile's cutoff poll.
"""

from __future__ import annotations

import dataclasses

import torch

from ddo_tpu_torch.core.types import CompilationType
from ddo_tpu_torch.engine.mdd import DDCompiler, _batch_stats, compile_lanes, tmap
from ddo_tpu_torch.search.solver import SequentialSolver


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis (stands in for
    `jax.sharding.Mesh`)."""

    devices: tuple
    axis: str = "lanes"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = "lanes") -> Mesh:
    """A mesh of `devices` (default: every CUDA device; without one it
    raises, there is no CPU fallback).  `make_mesh(["cpu"] * N)` is the
    plain route.  Entries may repeat: that exists so that the lane split
    runs where there is a single device (N "cpu" entries, or two entries
    of one card), not as a way to use a device twice."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu'] * N for "
                               "the plain PyTorch route")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices, axis)


class MeshCompiler(DDCompiler):
    """A `DDCompiler` whose lane batches are padded to a mesh multiple and
    split across the mesh's devices, one shard per device."""

    def __init__(self, bundle, width, cutset_type, mesh: Mesh, axis: str = "lanes",
                 dominance=None):
        super().__init__(bundle, width, cutset_type, dominance=dominance,
                         device=mesh.devices[0])
        self.mesh = mesh
        self.axis = axis
        self.lanes = mesh.size
        # each distinct device's instance tensors, built once
        self._datas = {self.device: self.datas}
        for d in mesh.devices:
            if d not in self._datas:
                self._datas[d] = bundle.datas(d)

    def _prep(self, subs, eff_widths, best_lb):
        """The padded lanes' roots on the first device and their `actives`:
        K = lanes * ceil(len(subs) / lanes), pads are inactive copies of
        subs[0] at effective width 1 (ddo_tpu's `_prep_batch`)."""
        K = self.lanes * -(-len(subs) // self.lanes)
        pads = K - len(subs)
        roots = self._roots(list(subs) + [subs[0]] * pads, list(eff_widths) + [1] * pads,
                            best_lb)
        actives = torch.arange(K, device=self.device) < len(subs)
        return roots, actives

    def _shards(self, spec, subs, roots, best_lb, cache_tab, dom_tab, cutoff=None,
                chunk_layers=None):
        """Compile shard j of the lanes on mesh device j, every shard from
        the whole batch's minimum root depth; returns the outputs gathered
        onto the first device in lane order."""
        states, values, depths, _, widths, psets = roots
        k = values.shape[0] // self.lanes
        start = min(s.depth for s in subs)
        tables = {}
        outs = []
        for j, dev in enumerate(self.mesh.devices):
            if dev not in tables:
                tables[dev] = tuple(None if t is None else {n: v.to(dev) for n, v in t.items()}
                                    for t in (cache_tab, dom_tab))
            on = lambda x: x[j * k:(j + 1) * k].to(dev)
            outs.append(compile_lanes(
                spec, self._datas[dev], self.order, tmap(on, states), on(values), on(depths),
                on(best_lb), on(widths), on(psets), cache_tab=tables[dev][0],
                dom_tab=tables[dev][1], cutoff=cutoff, chunk_layers=chunk_layers, start=start))
        if len(outs) == 1:  # one shard: its planes, without a copy
            return outs[0]
        return {name: tmap(lambda *xs: torch.cat([x.to(self.device) for x in xs]),
                           *(o[name] for o in outs)) for name in outs[0]}

    def compile_batch(self, comp_type: CompilationType, subs, best_lb, eff_widths,
                      cache_tab=None, dom_tab=None, cutoff=None, chunk_layers=None):
        """`DDCompiler.compile_batch` over the mesh: views for the real
        lanes only, reductions over them only.  With `chunk_layers` and a
        `cutoff`, `CutoffInterrupt` propagates from the first shard that
        polls it firing."""
        spec = self._specs[comp_type]
        roots, actives = self._prep(subs, eff_widths, best_lb)
        out = self._shards(spec, subs, roots, roots[3], cache_tab, dom_tab, cutoff=cutoff,
                           chunk_layers=chunk_layers)
        return self._batch(spec, subs, out, actives)

    def compile_fused(self, subs, best_lb, eff_widths, cache_tab=None, dom_tab=None):
        """`DDCompiler.compile_fused` over the mesh: the restricted pass on
        every shard, then the active lanes' best across all shards, then
        the relaxed pass on every shard against max(best_lb, that) (the
        order XLA's in-graph reduction gives ddo_tpu)."""
        spec_r = self._specs[CompilationType.RESTRICTED]
        spec_x = self._specs[CompilationType.RELAXED]
        roots, actives = self._prep(subs, eff_widths, best_lb)
        out_r = self._shards(spec_r, subs, roots, roots[3], cache_tab, dom_tab)
        g_r, _ = _batch_stats(out_r, actives)
        out_x = self._shards(spec_x, subs, roots, torch.maximum(roots[3], g_r), cache_tab,
                             dom_tab)
        need_x = actives & ~(out_r["is_exact_dd"] | out_r["has_ebp"])
        return (self._batch(spec_r, subs, out_r, actives),
                self._batch(spec_x, subs, out_x, need_x))


def MeshSolver(bundle, mesh: Mesh = None, batch: int = None, **kw):
    """Branch-and-bound whose supersteps' K lanes are split across `mesh`
    (default: `make_mesh()`, every card): a `SequentialSolver` on the
    mesh's first device with a `MeshCompiler` of the same width, cutset
    and dominance in place of its compiler.  The replacement for the
    reference's thread pool (parallel.rs:287-653); a `cutoff` with
    chunked compiles interrupts mid-compile as on one device."""
    mesh = mesh if mesh is not None else make_mesh()
    solver = SequentialSolver(bundle, batch=batch or mesh.size, device=mesh.devices[0], **kw)
    c = solver.compiler
    solver.compiler = MeshCompiler(bundle, c.width, c.cutset_type, mesh,
                                   dominance=c.dominance)
    return solver
