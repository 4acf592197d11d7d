#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`ddo_tpu_torch`) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device and build: the card's name and power limit (nvidia-smi), then
     kernels K1 (csrc/lane_sort.cu) and K2 (csrc/backward.cu) built by
     nvcc from the sources in this checkout;
  2. each kernel against its plain PyTorch version on the card, bit-equal
     on every output, at the main path's shapes (K1: the knapsack sort-1
     and sort-2 at 128 lanes x 512 rows, a non-power-of-two row count and
     one lane; K2: 128 lanes x 2000 layers x W=256 x D=2, and one lane),
     with both times;
  3. the main path at real size: a seeded uncorrelated knapsack with
     n=2000 (Pisinger's knapPI_1 family), a restricted and a relaxed
     compile of 128 root lanes at W=256 bracketing the exact DP optimum,
     each followed by the solver's host extraction of all 128 lanes (the
     incumbent, the cache rows, the cutset into the fringe), each timed;
     one superstep of `maximize`'s own route on the same 128 lanes
     (`compile_fused` with the cache and dominance filters, then the
     extraction into the cache and the dominance store), timed; and a
     small compile whose planes must equal the CPU path's;
  4. `ddo_tpu_torch.maximize` proving the same n=2000 instance's DP
     optimum at width 256, batch 128, cache and dominance on, gap 0;
then the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Every check raises on failure, so the script exits non-zero and prints no
result; without CUDA it exits non-zero at once.  Launch counters are
zeroed just before phases 3-4 and must both have grown by their end.
"""

import dataclasses
import json
import subprocess
import sys
import time

SEED = 0
K_LANES, N_ITEMS, WIDTH = 128, 2000, 256  # bench.py:184's knapsack shape


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, reps):
    """Mean time of `fn` over `reps` calls between two CUDA events.  A
    ~0.1 s device spin is queued first, so the calls queue up behind it
    and the events time them back to back on the device, without the
    host's issue time; a call that issues more slowly than the device runs
    (the plain versions: hundreds of small launches) is timed at its issue
    rate all the same."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(torch, ref, got):
    err = 0
    for r, g in zip(ref, got):
        if r.shape != g.shape or r.dtype != g.dtype:
            raise AssertionError(f"shape/dtype {r.shape} {r.dtype} vs {g.shape} {g.dtype}")
        if r.numel():
            err = max(err, int((r.to(torch.int64) - g.to(torch.int64)).abs().max()))
    return err


def sort_case(torch, gen, L, C, nk, npay, dev):
    """Operands shaped like the engine's sorts: a 0/1 validity key, wide
    keys, a unique final key (-idx), random payloads."""
    ri = lambda lo, hi: torch.randint(lo, hi, (L, C), generator=gen, device=dev,
                                      dtype=torch.int32)
    keys = [ri(0, 2)] + [ri(-5000, 5000) for _ in range(nk - 2)]
    keys.append(-torch.argsort(torch.rand((L, C), generator=gen, device=dev), dim=1)
                .to(torch.int32))
    return keys + [ri(-(1 << 20), 1 << 20) for _ in range(npay)]


def backward_case(torch, gen, K, n, W, D, dev):
    """tests/test_backward_pallas.py:46-67's random planes, on the device."""
    from ddo_tpu_torch.utils.num import INF, NEG_INF

    C = W * D
    i32 = torch.int32
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device=dev,
                                             dtype=i32)
    rb = lambda p, shape: torch.rand(shape, generator=gen, device=dev) < p
    where = lambda p, lo, hi, alt, shape: torch.where(rb(p, shape), ri(lo, hi, shape),
                                                      alt).to(i32)
    wlp = rb(0.15, (K, n, W))
    return [ri(-1, W, (K, n, C)), ri(-20, 20, (K, n, C)), rb(0.6, (K, n, C)),
            ri(-50, 50, (K, n, W)), ri(0, 60, (K, n, W)), rb(0.2, (K, n, W)),
            rb(0.5, (K, n, W)), rb(0.8, (K, n, W)),
            where(0.5, -5, 5, NEG_INF, (K, W)), where(0.5, -30, 30, INF, (K, W)),
            ri(-20, 40, (K,)),
            where(0.2, -30, 30, INF, (K, n, W)), wlp,
            torch.where(wlp, ri(-30, 30, (K, n, W)), INF).to(i32)]


def phase_kernels(torch, dev):
    """Phase 2: K1 and K2 against their plain versions on the card."""
    from ddo_tpu_torch.engine import backward as bwd
    from ddo_tpu_torch.ops import sort as srt

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = {}
    for label, L, C, nk, npay in [("sort1", K_LANES, WIDTH * 2, 4, 4),
                                  ("sort2", K_LANES, WIDTH * 2, 4, 0),
                                  ("non_pow2", 16, 300, 3, 2),
                                  ("one_lane", 1, WIDTH * 2, 4, 4)]:
        ops = sort_case(torch, gen, L, C, nk, npay, dev)
        ref = srt.multi_sort_plain(ops, nk)
        got = srt.multi_sort_cuda(ops, nk)
        torch.cuda.synchronize()
        err = max_abs_err(torch, ref, got)
        if err or not all(torch.equal(r, g) for r, g in zip(ref, got)):
            raise AssertionError(f"K1 {label} disagrees with its plain version")
        ms = time_ms(torch, lambda: srt.multi_sort_cuda(ops, nk), 50)
        plain_ms = time_ms(torch, lambda: srt.multi_sort_plain(ops, nk), 20)
        rows[("lane_sort", label)] = (err, ms, plain_ms)
        log(json.dumps({"phase": "kernel", "kernel": "lane_sort", "case": label,
                        "shape": [L, C], "keys": nk, "payloads": npay,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}))
    for label, K in [("main", K_LANES), ("one_lane", 1)]:
        args = backward_case(torch, gen, K, N_ITEMS, WIDTH, 2, dev)
        ref = bwd.backward_scans(*args)
        got = bwd.fused_backward_cuda(*args)
        torch.cuda.synchronize()
        err = max_abs_err(torch, ref, got)
        if err or not all(torch.equal(r, g) for r, g in zip(ref, got)):
            raise AssertionError(f"K2 {label} disagrees with its plain version")
        ms = time_ms(torch, lambda: bwd.fused_backward_cuda(*args), 10)
        plain_ms = time_ms(torch, lambda: bwd.backward_scans(*args), 2)
        rows[("fused_backward", label)] = (err, ms, plain_ms)
        log(json.dumps({"phase": "kernel", "kernel": "fused_backward", "case": label,
                        "shape": [K, N_ITEMS, WIDTH, 2], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms}))
        del args, ref, got
    return rows


def phase_compile(torch, dev, n=N_ITEMS, K=K_LANES, W=WIDTH):
    """Phase 3: the real-size shape.  Restricted + relaxed compiles of K
    root lanes bracketing the DP optimum (bench.py's expansions/s), each
    followed by the solver's host extraction; one superstep of the
    solver's fused route on the same lanes; a small compile equal to the
    CPU's."""
    import numpy as np

    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import knapsack as kp

    pb = kp.generate_uncorrelated(n, 1000, 1, 100, SEED)
    t0 = time.perf_counter()
    opt = kp.dp_optimum(pb.capacity, pb.profit, pb.weight)
    log(json.dumps({"phase": "dp", "n": n, "capacity": pb.capacity, "optimum": opt,
                    "dp_s": time.perf_counter() - t0}))
    # A superstep of the solver's two-pass route at K lanes x W: the
    # restricted compile, its host extraction, the relaxed compile, its
    # host extraction (incumbent, cache rows, cutset into the fringe), by
    # the solver's own methods.  The lanes are K copies of the root at
    # best_lb = NEG_INF, with no dominance (bench.py's kernel_rate shape):
    # the search itself never fills K lanes on this family, whose
    # restricted DDs close the instance at once (phase 4).  Planes cross
    # to the host once each, on first touch.
    solver = tt.SequentialSolver(tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()),
                                 width_heu=tt.FixedWidth(W), batch=K,
                                 cache=tt.SimpleCache(), device=dev)
    solver.cache.initialize(pb)
    roots = [tt.root_subproblem(pb)] * K
    for label, comp in [("restricted", tt.CompilationType.RESTRICTED),
                        ("relaxed", tt.CompilationType.RELAXED)]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batch = solver.compiler.compile_batch(comp, roots, tt.NEG_INF, [W] * K)
        expanded = batch.total_expanded  # waits for the device
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        best = [dd.best_value() for dd in batch]
        if label == "relaxed" and not all(b is not None and b >= opt for b in best):
            raise AssertionError(f"relaxed bound {best[0]} below the optimum {opt}")
        if label == "restricted" and not all(b is None or b <= opt for b in best):
            raise AssertionError(f"restricted value {best[0]} above the optimum {opt}")
        t0 = time.perf_counter()
        inexact = 0
        for nd, dd in zip(roots, batch):
            solver._maybe_update_best(dd)
            solver._apply_cache_updates(dd)
            if label == "relaxed" and not dd.is_exact():
                inexact += 1
                solver._enqueue_cutset(nd, dd)
        extraction = time.perf_counter() - t0
        d2h = sum(a.nbytes for v in batch._planes._np.values()
                  for a in (v.values() if isinstance(v, dict) else [v]))
        log(json.dumps({"phase": "compile", "pass": label, "lanes": K, "n": n,
                        "width": W, "optimum": opt, "best_value": best[0],
                        "expanded": expanded, "wall_s": wall,
                        "expansions_per_s": expanded / wall, "peak_bytes": peak,
                        "extraction_s": extraction, "d2h_bytes": d2h,
                        "incumbent": solver.best_lb, "inexact_lanes": inexact,
                        "fringe": len(solver.fringe)}))
        del batch
    if solver.best_lb > opt:
        raise AssertionError(f"incumbent {solver.best_lb} above the optimum {opt}")
    top = solver.fringe.pop()  # the largest upper bound still open
    if solver.best_lb < opt and (top is None or top.ub < opt):
        raise AssertionError("no open subproblem can reach the optimum")
    del solver

    # One superstep of `maximize` itself at K lanes, on a fresh solver
    # built as `maximize(..., use_cache=True, width=W, batch=K,
    # dominance=...)` builds it: compile_fused with the cache and
    # dominance snapshots as filters, then the host extraction (the
    # incumbent, the cache rows, every exact node into the dominance
    # store; the relaxed pass's cutset for lanes whose restricted DD is
    # inexact).
    solver = tt.SequentialSolver(
        tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()), width_heu=tt.FixedWidth(W),
        cache=tt.SimpleCache(), fringe=tt.NoDupFringe(), batch=K, device=dev,
        dominance=tt.SimpleDominanceChecker(kp.KPDominance(), pb.nb_variables))
    solver.cache.initialize(pb)
    solver.dominance.prime(pb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solver._process_batch_fused(roots, [W] * K)
    st = solver.stats
    if solver.best_lb > opt or (len(solver.fringe) == 0 and solver.best_lb != opt):
        raise AssertionError(f"superstep incumbent {solver.best_lb} vs optimum {opt}")
    log(json.dumps({"phase": "superstep", "lanes": K, "n": n, "width": W,
                    "expanded": solver.expanded_nodes, "compile_s": st.restricted_s,
                    "extraction_s": st.host_s,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "incumbent": solver.best_lb, "fringe": len(solver.fringe)}))
    del solver

    # the whole engine on the device against the CPU path (which the CPU
    # tests hold against ddo_tpu), every plane, on a small instance with
    # lanes rooted at different depths
    small = kp.generate_uncorrelated(60, 1000, 1, 20, SEED + 1)
    sb = tt.ModelBundle(small, kp.KPRelax(small), kp.KPRanking())
    dom = kp.KPDominance()
    root = tt.root_subproblem(small)
    subs = [root, root]
    for depth in (7, 20):
        pset = np.zeros(small.nb_variables, bool)
        pset[:depth] = True
        state = {"capacity": np.asarray(small.capacity // 2, np.int32)}
        subs.append(dataclasses.replace(root, state=state, value=100 * depth,
                                        path_set=pset, depth=depth))
    planes = {}
    for d in (dev, torch.device("cpu")):
        c = tt.DDCompiler(sb, 16, tt.FRONTIER, dominance=dom, device=d)
        rs, xs = c.compile_fused(subs, tt.NEG_INF, [3, 5, 8, 16])
        planes[d.type] = [b._planes for b in (rs, xs)]
    keys = [k for k in planes["cpu"][0]._dev if k != "state"]
    for a, b in zip(planes[dev.type], planes["cpu"]):
        for k in keys:
            if not np.array_equal(a.get(k), b.get(k)):
                raise AssertionError(f"plane {k} differs between {dev} and cpu")
        if not np.array_equal(a.get("state")["capacity"], b.get("state")["capacity"]):
            raise AssertionError(f"state plane differs between {dev} and cpu")
    log(json.dumps({"phase": "compile_vs_cpu", "n": 60, "lanes": len(subs),
                    "root_depths": [s.depth for s in subs], "planes": len(keys),
                    "equal": True}))
    return pb, opt


def phase_solve(torch, dev, pb, opt, W=WIDTH, batch=K_LANES):
    """Phase 4: `maximize` proves the real-size instance's optimum at
    width W, cache and dominance on."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.engine import backward as bwd
    from ddo_tpu_torch.models import knapsack as kp
    from ddo_tpu_torch.ops import sort as srt

    before = srt.KERNEL_LAUNCHES, bwd.KERNEL_LAUNCHES
    sol = tt.maximize(pb, kp.KPRelax(pb), kp.KPRanking(), use_cache=True, width=W,
                      batch=batch,
                      dominance=tt.SimpleDominanceChecker(kp.KPDominance(),
                                                          pb.nb_variables),
                      device=dev)
    if sol.aborted or sol.gap != 0 or sol.objective != opt:
        raise AssertionError(f"maximize: {sol} vs DP optimum {opt}")
    # K2 runs once per pass: two per superstep
    log(json.dumps({"phase": "solve", "n": pb.nb_variables, "width": W,
                    "batch": batch, "optimum": opt, "objective": sol.objective,
                    "gap": sol.gap, "time_to_optimum_s": sol.duration,
                    "lane_sort_launches": srt.KERNEL_LAUNCHES - before[0],
                    "fused_backward_launches": bwd.KERNEL_LAUNCHES - before[1]}))
    return sol


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from ddo_tpu_torch.engine import backward as bwd
    from ddo_tpu_torch.ops import sort as srt

    # ---- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"phase": "device", "torch": torch.__version__,
                    "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)}))
    t0 = time.perf_counter()
    srt._lib()
    bwd._lib()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}))

    # ---- 2. kernels against their plain versions
    rows = phase_kernels(torch, dev)

    # ---- 3 + 4. the main path; only its launches are counted
    srt.KERNEL_LAUNCHES = 0
    bwd.KERNEL_LAUNCHES = 0
    pb, opt = phase_compile(torch, dev)
    phase_solve(torch, dev, pb, opt)
    launches = {"lane_sort": srt.KERNEL_LAUNCHES, "fused_backward": bwd.KERNEL_LAUNCHES}
    log(json.dumps({"phase": "launches", **launches}))
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    kernels = []
    for name, src, replaces, main_case in [
        ("lane_sort", "ddo_tpu_torch/csrc/lane_sort.cu",
         "ddo_tpu/ops/sort_pallas.py:285", "sort1"),
        ("fused_backward", "ddo_tpu_torch/csrc/backward.cu",
         "ddo_tpu/engine/backward.py:346", "main"),
    ]:
        err = max(v[0] for k, v in rows.items() if k[0] == name)
        _, ms, plain_ms = rows[(name, main_case)]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
