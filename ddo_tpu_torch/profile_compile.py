"""Where the time of one K-lane compile, or of one search, goes on a GPU.

    python -m ddo_tpu_torch.profile_compile [knapsack|misp|tsptw|search]

Runs one of `chip_smoke.py`'s real-size shapes, a relaxed `compile_batch`
of 128 root lanes at buffer width 256 on `cuda:0`, of
`generate_uncorrelated(2000, 1000, 1, 100, seed=0)` (knapsack, the
default), of `generate_gnp(200, 0.1, seed=0)` (misp: a dynamic order,
long arcs, 7-word bitset states) or of the 61-node TSPTW instance
`tsptw.generate_random(61, 0, window=200.0)` with its dominance filter
(lanes of 15,616 candidates, K1's "merge" route): once to warm up, three
times timed on the
wall clock (the compile is bound by the host, whose speed varies from run
to run), and once under `torch.profiler`.  Prints one JSON line: the
median wall time (total and per layer) and every timed run's, the kernel
launches (total and per layer, counted from the CUDA runtime's launch
calls), the device time (the sum of every kernel's and copy's own device
time), the device's idle share of the median unprofiled wall time, the
port's own kernels (K1 `lane_sort_*`, K2 `backward_*`: calls, device time
per call; the "merge" route's two kernels are `merge_*`) and the top
device-time entries.  The profiler's table goes to
standard error.

`search` runs chip_smoke phase 13's first shape instead: `maximize` of
`SequentialSolver` and of `DeviceLoopSolver` (a slab of 8,192 rows, 16
supersteps per chunk, a cut cap of 4,096) on MISP
`generate_gnp(60, 0.2, seed=0)` at width 256 with 128 lanes and the
cache: each once to warm up, then timed in turns (sequential, device
loop, device loop, sequential), then each once under `torch.profiler`.
Its JSON line gives per solver the wall times, supersteps, kernel
launches (total and per superstep), host synchronizations (stream,
device and event synchronize calls), copies, the device time, the
device's idle share of the mean unprofiled wall time and the entries
with the most host time of their own.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType

LANES, WIDTH, SEED = 128, 256, 0
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def _device_us(entry) -> float:
    """An aggregated profiler entry's own device time (us), under either
    of the attribute names torch releases use."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(entry, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _on_device(entry) -> bool:
    """A kernel or copy that ran on the GPU (the entries whose own device
    time the profiler's "Self CUDA time total" adds up)."""
    return (entry.device_type == DeviceType.CUDA
            and not getattr(entry, "is_user_annotation", False))


def _bundle(tt, model):
    """(bundle, dominance or None) of `model`'s real-size shape."""
    if model == "knapsack":
        from ddo_tpu_torch.models import knapsack as kp

        pb = kp.generate_uncorrelated(2000, 1000, 1, 100, SEED)
        return tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()), None
    if model == "tsptw":
        from ddo_tpu_torch.models import tsptw as ts

        pb = ts.generate_random(61, SEED, window=200.0)
        return tt.ModelBundle(pb, ts.TsptwRelax(pb), ts.TsptwRanking()), ts.TsptwDominance()
    from ddo_tpu_torch.models import misp as mi

    pb, _ = mi.generate_gnp(200, 0.1, SEED)
    return tt.ModelBundle(pb, mi.MispRelax(pb), mi.MispRanking(pb)), None


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
_COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")


def _search(tt, dev) -> dict:
    """The `search` mode (see the module doc)."""
    from ddo_tpu_torch.models import misp as mi

    pb, _ = mi.generate_gnp(60, 0.2, SEED)
    bundle = tt.ModelBundle(pb, mi.MispRelax(pb), mi.MispRanking(pb))
    kw = dict(width_heu=tt.FixedWidth(WIDTH), batch=LANES, device=dev)
    make = {"sequential": lambda: tt.SequentialSolver(bundle, cache=tt.SimpleCache(), **kw),
            "device_loop": lambda: tt.DeviceLoopSolver(
                bundle, cache=tt.SimpleCache(), slab_cap=8192, chunk_steps=16,
                cut_cap=4096, **kw)}

    def solve(kind):
        s = make[kind]()
        s.maximize()
        torch.cuda.synchronize()
        return s

    for kind in make:
        solve(kind)
    walls = {kind: [] for kind in make}
    for kind in ("sequential", "device_loop", "device_loop", "sequential"):
        t0 = time.perf_counter()
        s = solve(kind)
        walls[kind].append(time.perf_counter() - t0)
    out = {"phase": "profile_search", "model": "misp", "n": pb.nb_variables,
           "lanes": LANES, "width": WIDTH}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for kind in make:
        with torch.profiler.profile(activities=acts) as prof:
            s = solve(kind)
        entries = prof.key_averages()
        calls = lambda names: sum(e.count for e in entries if e.key in names)
        device_us = sum(_device_us(e) for e in entries if _on_device(e))
        wall = sum(walls[kind]) / len(walls[kind])
        launches = calls(_LAUNCH_CALLS)
        host = sorted(entries, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
        out[kind] = {"wall_runs_s": walls[kind], "supersteps": s.stats.supersteps,
                     "best": s.best_value(), "launches": launches,
                     "launches_per_superstep": launches / max(1, s.stats.supersteps),
                     "syncs": calls(_SYNC_CALLS), "copies": calls(_COPY_CALLS),
                     "device_ms": device_us / 1e3,
                     "device_idle_share": 1.0 - device_us / 1e6 / wall,
                     "top_host": [{"name": e.key, "count": e.count,
                                   "self_cpu_ms": e.self_cpu_time_total / 1e3}
                                  for e in host]}
    return out


def main(argv) -> int:
    model = argv[1] if len(argv) > 1 else "knapsack"
    if model not in ("knapsack", "misp", "tsptw", "search"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_compile: no CUDA device", file=sys.stderr)
        return 2

    import ddo_tpu_torch as tt

    dev = torch.device("cuda", 0)
    if model == "search":
        print(json.dumps(_search(tt, dev)), flush=True)
        return 0
    bundle, dominance = _bundle(tt, model)
    pb = bundle.problem
    n_layers = pb.nb_variables
    compiler = tt.DDCompiler(bundle, WIDTH, tt.LAST_EXACT_LAYER, dominance=dominance,
                             device=dev)
    roots = [tt.root_subproblem(pb)] * LANES

    def compile_once():
        batch = compiler.compile_batch(tt.CompilationType.RELAXED, roots, tt.NEG_INF,
                                       [WIDTH] * LANES)
        expanded = batch.total_expanded  # waits for the device
        torch.cuda.synchronize()
        return expanded

    compile_once()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        expanded = compile_once()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        compile_once()
    profiled_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries = prof.key_averages()
    launches = sum(e.count for e in entries if e.key in _LAUNCH_CALLS)
    on_device = [e for e in entries if _on_device(e)]
    device_us = sum(_device_us(e) for e in on_device)
    top = sorted(on_device, key=_device_us, reverse=True)[:12]
    ours = [e for e in on_device
            if any(k in e.key for k in ("lane_sort", "merge_", "backward_"))]
    analysis = time.perf_counter() - t0

    key = next((k for k in ("self_device_time_total", "self_cuda_time_total")
                if entries and hasattr(entries[0], k)), None)
    print(entries.table(sort_by=key, row_limit=60), file=sys.stderr)
    print(json.dumps({
        "phase": "profile_compile", "model": model, "n": n_layers, "lanes": LANES,
        "width": WIDTH, "expanded": expanded,
        "wall_s": wall, "wall_ms_per_layer": 1e3 * wall / n_layers, "wall_runs_s": walls,
        "profiled_wall_s": profiled_wall, "analysis_s": analysis,
        "launches": launches, "launches_per_layer": launches / n_layers,
        "device_ms": device_us / 1e3,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "port_kernels": [{"name": e.key, "count": e.count, "device_ms": _device_us(e) / 1e3,
                          "us_per_call": _device_us(e) / e.count} for e in ours],
        "top": [{"name": e.key, "count": e.count, "device_ms": _device_us(e) / 1e3,
                 "share": _device_us(e) / device_us if device_us else 0.0}
                for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
