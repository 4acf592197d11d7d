#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`ddo_tpu_torch`) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device and build: the card's name and power limit (nvidia-smi), then
     kernels K1 (csrc/lane_sort.cu) and K2 (csrc/backward.cu) built by
     nvcc from the sources in this checkout, one nvcc per source started
     together, with ptxas's registers, shared memory and spills per kernel;
  2. each kernel against its plain PyTorch version on the card, bit-equal
     on every output, at the main path's shapes (K1: the knapsack sort-1
     and sort-2 at 128 lanes x 512 rows, a non-power-of-two row count and
     one lane; K2: 128 lanes x 2000 layers x W=256 x D=2, and one lane)
     and at each route's boundaries (K1 at 32, 64 and 2048 rows and on
     its "perm" route; K2 with fewer layers than a ring block, and on its
     direct route at W=1100 and W=4096), each with its time, the plain version's, the
     least time the card could take (`bound_ms`, bytes or operations) and
     the share of it reached; K1's earlier "perm" route is timed beside
     its "regs" route in turns wherever both take the shape;
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
import re
import subprocess
import sys
import time

SEED = 0
K_LANES, N_ITEMS, WIDTH = 128, 2000, 256  # bench.py:184's knapsack shape

# An H100 SXM's peaks (NVIDIA's data sheet): 3.35 TB/s of HBM, and the
# int32 rate of 64 INT32 lanes per SM x 132 SMs x 1.98 GHz, the boost clock
# behind the data sheet's 67 TFLOP/s of float32.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def log(*a):
    print(*a, flush=True)


def ptxas_summary(report):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from
    `nvcc -Xptxas -v`'s report (template arguments kept as <N>)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"_Z\d+(\w+?_kernel)(?:ILi(\d+)E)?", m.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")) if k \
                else m.group(1)
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


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


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes' time at the memory
    rate and the int32 operations' time at the int32 rate."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sort_bound(L, C, nk, n_ops):
    """K1: each operand read once and written once; a bitonic network of
    C2/2 compare-exchanges per stage over log2(C2)(log2(C2)+1)/2 stages,
    each compare-exchange 3 int32 operations (a compare and a select into
    each output) per key word and for the row index."""
    C2 = 1 << max(1, (C - 1).bit_length())
    lg = C2.bit_length() - 1
    exchanges = L * (C2 // 2) * lg * (lg + 1) // 2
    return bound(8 * n_ops * L * C, exchanges * 3 * (nk + 1))


def backward_bound(K, n, W, D):
    """K2: its 11 input planes (9 B per edge, 20 B per node), 4 output
    planes (10 B per node) and the carries' initial rows, each byte once;
    the int32 operations of csrc/backward.cu's sweep_layer, 14 per edge
    and 30 per node."""
    C = W * D
    return bound(K * n * (9 * C + 30 * W) + K * (8 * W + 4), K * n * (14 * C + 30 * W))


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
    """Phase 2: K1 and K2 against their plain versions on the card.
    Returns {(kernel, case): row}, each row the case's JSON line."""
    from ddo_tpu_torch.engine import backward as bwd
    from ddo_tpu_torch.ops import sort as srt

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = {}
    # K1: the main path's sorts, then each route's boundaries
    for label, L, C, nk, npay in [("sort1", K_LANES, WIDTH * 2, 4, 4),
                                  ("sort2", K_LANES, WIDTH * 2, 4, 0),
                                  ("non_pow2", 16, 300, 3, 2),
                                  ("one_lane", 1, WIDTH * 2, 4, 4),
                                  ("rows_32", K_LANES, 32, 4, 4),
                                  ("rows_64", K_LANES, 64, 4, 4),
                                  ("rows_2048", K_LANES, 2048, 4, 4),
                                  ("keys_9", 16, 300, 9, 2)]:
        ops = sort_case(torch, gen, L, C, nk, npay, dev)
        ref = srt.multi_sort_plain(ops, nk)
        route = srt.lane_sort_route(nk, C)
        # both routes where both apply, each held to the plain version
        routes = ["regs", "perm"] if route == "regs" else [route]
        for r_ in routes:
            got = srt.multi_sort_cuda(ops, nk, route=r_)
            torch.cuda.synchronize()
            err = max_abs_err(torch, ref, got)
            if err or not all(torch.equal(r, g) for r, g in zip(ref, got)):
                raise AssertionError(f"K1 {label} ({r_}) disagrees with its plain version")
        # in turns (old, new, new, old), so that both come from one card
        ms = {r_: [] for r_ in routes}
        for r_ in routes + routes[::-1]:
            ms[r_].append(time_ms(torch, lambda: srt.multi_sort_cuda(ops, nk, route=r_), 50))
        plain_ms = time_ms(torch, lambda: srt.multi_sort_plain(ops, nk), 20)
        b_ms, b_by = sort_bound(L, C, nk, nk + npay)
        new_ms = sum(ms[route]) / len(ms[route])
        row = {"phase": "kernel", "kernel": "lane_sort", "case": label, "route": route,
               "shape": [L, C], "keys": nk, "payloads": npay, "max_abs_err": err,
               "ms": new_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "share_of_bound": b_ms / new_ms}
        if route == "regs":
            row["perm_route_ms"] = sum(ms["perm"]) / len(ms["perm"])
        rows[("lane_sort", label)] = row
        log(json.dumps(row))
    # K2: the main path's sweeps, then fewer layers than a ring block, and
    # the direct route (W not a multiple of 16; W too large for the ring)
    for label, K, n, W, D, reps in [("main", K_LANES, N_ITEMS, WIDTH, 2, 10),
                                    ("one_lane", 1, N_ITEMS, WIDTH, 2, 10),
                                    ("layers_3", K_LANES, 3, WIDTH, 2, 50),
                                    ("width_1100", 8, 50, 1100, 3, 20),
                                    ("direct", 4, 50, 4096, 2, 20)]:
        args = backward_case(torch, gen, K, n, W, D, dev)
        ref = bwd.backward_scans(*args)
        got = bwd.fused_backward_cuda(*args)
        torch.cuda.synchronize()
        err = max_abs_err(torch, ref, got)
        if err or not all(torch.equal(r, g) for r, g in zip(ref, got)):
            raise AssertionError(f"K2 {label} disagrees with its plain version")
        ms = time_ms(torch, lambda: bwd.fused_backward_cuda(*args), reps)
        plain_ms = time_ms(torch, lambda: bwd.backward_scans(*args), 2)
        b_ms, b_by = backward_bound(K, n, W, D)
        block = bwd.backward_plan(W, D)[0]
        row = {"phase": "kernel", "kernel": "fused_backward", "case": label,
               "route": "tma" if block else "direct", "block_layers": block,
               "shape": [K, n, W, D],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "share_of_bound": b_ms / ms}
        rows[("fused_backward", label)] = row
        log(json.dumps(row))
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
    from ddo_tpu_torch.utils import cuda_build

    # ---- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"phase": "device", "torch": torch.__version__,
                    "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)}))
    t0 = time.perf_counter()
    cuda_build.build("lane_sort", "backward")
    srt._lib()
    bwd._lib()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}))
    for name in ("lane_sort", "backward"):
        log(json.dumps({"phase": "ptxas", "source": f"ddo_tpu_torch/csrc/{name}.cu",
                        "kernels": ptxas_summary(cuda_build.ptxas_report(name))}))

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
        main = rows[(name, main_case)]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                                           if k[0] == name),
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                        "share_of_bound": main["share_of_bound"],
                        # no single PyTorch call sorts lanes lexicographically
                        # on several keys with payloads, or runs the sweep
                        "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
