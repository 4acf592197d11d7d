#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`ddo_tpu_torch`) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device and build: the card's name and power limit (nvidia-smi), then
     kernels K1 (csrc/lane_sort.cu) and K2 (csrc/backward.cu) built by
     nvcc from the sources in this checkout, one nvcc per source started
     together, with ptxas's registers, shared memory and spills per kernel;
  2. each kernel against its plain PyTorch version on the card, bit-equal
     on every output, at the main paths' shapes (K1: the knapsack sort-1
     and sort-2 at 128 lanes x 512 rows, the MISP sorts on the "perm"
     route, the max2sat and max-cut sorts, TSPTW N60's two sorts at 128
     lanes x 15,616 rows, SOP with 380 jobs in one lane of 97,280 rows, 39
     keys, SRFLP n=60 with 70 operands, LCS with 10 strings x 20 letters,
     those four on the "merge" route, phase 16's sorts past 128 operands
     (141 and 226), the small models', the mesh's 64-lane MISP shards'
     and the tutorial's sorts; K2: 128 lanes x 2000 layers x W=256 x
     D=2, one lane, the MISP compile's 200 layers, the max2sat and
     max-cut sweeps, the TSPTW compile's 61 layers x W=256 x D=61, phase
     16's, the small models', the mesh shards' and the tutorial's
     sweeps) and at each route's boundaries (K1 at 32, 64 and 2048 rows; "perm" at 12 keys over 1,024
     rows and one more; keys that tie on the 12 words a record carries
     and differ later; "merge" at 1 row, at 1,023 to 1,025 rows, at its
     tile and window boundaries, at 50,000 rows, and with every key in
     {0, 1}, where the payloads too must be the stable plain version's; K2
     also at TSPTW N60's D=61 in 1, 4 and 60 lanes, SOP with 380 jobs in
     one lane and SRFLP n=60 in 16 lanes at W=256, with fewer layers than a ring
     block, at W=1100 (no bulk copy) and at W=4096), each with its time,
     the plain version's, the least time the card could take
     (`bound_ms`, bytes or operations, one yardstick for every route) and
     the share of it reached; every route of either kernel that takes a
     case is checked and timed, in turns (K2's "stream" also at one CTA
     per lane where its plan takes a cluster, and with one node pass in
     flight where its plan keeps more), and the knapsack sorts' and
     one 141-operand call's host time per call;
 2b. kernel K3 (csrc/layer_tail.cu), the layer body's tail in three
     parts, against its plain version on the card: one layer's
     arguments, recorded from an eager relaxed compile of each path's own
     model, instance, lanes and W (`K3_OF_PATH`: knapsack n=2000 and
     TSPTW N60 in 128 lanes at W=256, max2sat at 135 variables at W=256,
     the tutorial at W=8, ...), of the benchmark cells' one-lane shapes
     (knapsack n=100, 512 candidates; TSPTW N20, 5,376) and of SOP with
     380 jobs in one lane of 97,280, LCS 10 x 20 and SRFLP n=60; each
     part bit-equal on every output and buffer, with its time, the plain
     version's and its bound (the bytes it must read and write at 3.35
     TB/s);
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
  5. small compiles of 3 or 4 lanes rooted at different depths whose every
     plane must equal the CPU path's: a 40-vertex MISP graph, golomb with
     7 marks (a domain of 26 values, so lanes of 832 candidates with 9
     keys on K1's "perm" route) and talentsched with 10 scenes;
  6. the MISP path (a dynamic variable order per lane, long arcs, bitset
     states, the device-side row extraction): a seeded G(200, 0.1) graph
     with unit weights (the size class of the DIMACS brock200_1 and
     c-fat200-1 graphs), a restricted and a relaxed compile of 128 root
     lanes at W=256, each followed by the solver's compact extraction and
     then its plane extraction of the same batch, each on a view that has
     brought nothing to the host before its timer starts: the same rows in
     the same order, the same fringe and cache, both routes' bytes to the
     host and times; then the relaxed bound over the restricted value on
     every lane and the restricted solution checked as an independent set
     on the host;
  7. `maximize` to gap 0 on a seeded G(60, 0.2) graph against an exact
     branch and bound over Python-int bitmasks;
  8. `maximize` to gap 0 on a seeded max2sat and then on a seeded max-cut
     instance, each against brute force over all assignments;
  9. the TSPTW path at full width: a seeded 61-node instance of Langevin's
     N60 shape (60 customers and a depot in a square, windows around a
     random feasible tour, distances x10000), a restricted and a relaxed
     compile of 128 root lanes at W=256 with the dominance filter (no
     coordinate columns), each followed by the solver's compact
     extraction: both sorts of every layer on K1's "merge" route, the
     sweep on K2's "stream" route, the relaxed bound over the restricted
     value on every lane, a restricted tour replayed within every window
     at its value, the batch's cutset rows, launches and times;
 10. `maximize` on a seeded 21-node instance (the N20 class) at W=256 to
     gap 0 and to an exact DP over (visited set, last node) labels;
 11. for each of sop, srflp, lcs, psp and alp: a compile of 3 or 4 lanes
     rooted at different depths whose every plane equals the CPU path's,
     then `maximize` to gap 0 at a brute-force optimum (n <= 8);
 12. in no count: compiles at W=256 of the N20 TSPTW instance and of LCS
     with 10 strings x 20 letters, sort-1 on the "merge" route, every
     plane equal to the CPU path's;
 13. `DeviceLoopSolver` on MISP G(60, 0.2) against the exact optimum and
     against `SequentialSolver` at the same settings, in turns
     (sequential, device loop, device loop, sequential), at W=256 with 128
     lanes (a slab of 8,192 rows, 16 supersteps per chunk, a cut cap of
     4,096) and at W=8 with 16 lanes, every chunk under
     `torch.cuda.set_sync_debug_mode("error")`; then an 8-row slab with a
     4-row cut cap on a 20-item knapsack, whose slab-full drains,
     cutset-overflow replays and reseeds must give the CPU run's counts
     (K1 also runs the slab's pop and dedup sorts, one lane of 8,192 rows,
     in phase 2);
 14. `NativeSolver` (the C++ fringe and cache, built by g++ from the
     checkout) against exact optima: the n=200 knapsack of the README's
     recipe with the dominance store, MISP G(60, 0.2), TSPTW 21 nodes at
     W=256;
 15. `ddo_tpu_torch.cli.main` on a generated knapsack file: the default
     flags, `--device-loop` and `--dot`, each to the DP optimum;
 16. models past 128 sort operands: `_check_sort_operands` accepts
     max2sat and max-cut at 135 and 220 variables, and compiles of 4 lanes
     whose every plane equals the CPU path's: max2sat at 135 variables
     (141 operands) at W=32 on K1's "perm" route and at W=256 on "merge",
     max-cut at 135, max2sat at 220 (226 operands);
 17. `SequentialSolver.maximize` on phase 9's instance at W=256, 128
     lanes a superstep, cache and dominance on, for 20 s: the lanes of
     each compile, K2's launches by cluster size (its first supersteps
     compile few lanes, spread over clusters), the best tour replayed;
 18. the mesh (`ddo_tpu_torch.parallel.mesh`): phase 4's knapsack at
     W=256, 128 lanes a superstep, cache and dominance, by
     `SequentialSolver`, by `MeshSolver` on `make_mesh()` (the card) and
     on `make_mesh([card, card])` (two entries of one card, so the lanes
     split in two shards), in turns: each at the DP optimum, gap 0, with equal
     explored and expanded counts, its wall and its K1 and K2 launches
     by route; MISP G(60, 0.2) at W=256 and 128 lanes on the two-entry
     mesh (64-lane shards, each with its own dynamic order) against
     `exact_mis` and `SequentialSolver`'s counts; `MeshCompiler` on 3
     lanes rooted at depths 0, 7 and 20 of a 60-item knapsack on the
     two-entry mesh, its real lanes' planes and reductions equal to
     `DDCompiler`'s on the card bit for bit;
 19. the custom-model tutorial (examples/tutorial_custom_problem_torch.py,
     weighted interval scheduling, 14 jobs): its `main(device)` on the
     card at brute force's optimum, gap 0, with its Graphviz export;
then the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Every check raises on failure, so the script exits non-zero and prints no
result; without CUDA it exits non-zero at once.  Each path has launch
counts of its own, zeroed just before the path and read just after it:
knapsack (phases 3-4), MISP (6-7), max2sat and max-cut (8, one count
each), TSPTW (9-10), tsptw_search (17), sop, srflp, lcs, psp and alp
(11, one count each), device_loop (13: the device loop's own runs, each
zeroed just before it and read just after), native (14), cli (15),
wide (16), mesh (18) and tutorial (19); K1, K2 and K3 must have launched in each, and each kernel's
count is also kept by route (K2's "stream" route's also by cluster
size; K3's by part, with its replayed layers' runs).  Each path's line also gives its layer-loop iterations, those
replayed from CUDA graphs and the graphs captured and replayed: the
knapsack and TSPTW paths must replay layers, mcp and sop none (their
layer bodies wait on the host).  Phases 5 and 12 are in no count.

    python3 chip_smoke.py --parent DIR

also times, in phase 2, the K1 and K2 of another checkout at DIR (a
parent commit unpacked with `git archive`), on the route each would
choose, in turns with this checkout's routes, and K1's host time per
call of both.

    python3 chip_smoke.py --sweep-k2

builds the kernels (phase 1), then times K2's "stream" route at its
phase-2 cases under other values of its planner's constants
(`sweep_k2`), and stops.
"""

import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time

SEED = 0
K_LANES, N_ITEMS, WIDTH = 128, 2000, 256  # bench.py:184's knapsack shape
MISP_N, MISP_P = 200, 0.1  # the MISP compile's graph: G(n, p), unit weights
SMALL_N, SMALL_W, SMALL_BATCH = 16, 8, 16  # the max2sat and max-cut runs
TSPTW_N, TSPTW_WINDOW = 61, 200.0  # Langevin's N60 class: 60 customers and a depot
TSPTW_SMALL_N = 21  # the N20 class, for `maximize` against the exact oracle
TSPTW_SEARCH_S = 20.0  # the N60 search's time budget (phase 17)
# past 128 sort operands (phase 16): max2sat and max-cut at 135 variables
# (the frb15-9 instances' size, 141 operands), max2sat at 220 (frb20-11)
WIDE_N, WIDE_N2 = 135, 220
SMALL_MODELS_W, SMALL_MODELS_BATCH = 16, 4  # sop, srflp, lcs, psp, alp at n <= 8
# the device loop (phase 13): MISP G(60, 0.2) at W=256 with 128 lanes (3
# supersteps), then at W=8 with 16 lanes (20 supersteps); a slab of 8,192
# rows, 16 supersteps per chunk, a cut cap of 4,096 rows
DL_N, DL_P = 60, 0.2
DL_SHAPES = ((WIDTH, K_LANES), (8, 16))
DL_SLAB, DL_CHUNK, DL_CUT = 8192, 16, 4096
# NativeSolver (phase 14): the drive recipe's knapsack, generate_uncorrelated's
# (n, R, h, S, seed), at width 16 and 16 lanes
NATIVE_KP, NATIVE_W, NATIVE_BATCH = (200, 1000, 50, 100, 2), 16, 16
# the CLI (phase 15): a knapsack generate_uncorrelated(50, 1000, 1, 100, seed=1)
# at the CLI's defaults (width 2, 4 lanes: an 8-slot buffer)
CLI_KP, CLI_W, CLI_BATCH = (50, 1000, 1, 100, 1), 8, 4
# the tutorial (phase 19): weighted interval scheduling, 14 jobs, FixedWidth(4)
# (an 8-slot buffer), batch 4; its search closes in one superstep of one lane
TUTORIAL = "examples/tutorial_custom_problem_torch.py"
TUTORIAL_N, TUTORIAL_W, TUTORIAL_LANES = 14, 8, 1

# An H100 SXM's peaks (NVIDIA's data sheet): 3.35 TB/s of HBM, and the
# int32 rate of 64 INT32 lanes per SM x 132 SMs x 1.98 GHz, the boost clock
# behind the data sheet's 67 TFLOP/s of float32.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def log(*a):
    print(*a, flush=True)


def ptxas_summary(report):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from
    `nvcc -Xptxas -v`'s report (integer template arguments kept, as <N>
    or <N, CAP> with CAP the operand struct's capacity)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"_Z\d+(\w+?_kernel)", m.group(1))
            args = re.findall(r"ILi(\d+)E", m.group(1))
            name = (k.group(1) + (f"<{', '.join(args)}>" if args else "")) if k \
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
    """K1, the same yardstick for every route: each operand read once and
    written once, and a comparison sort's C2 log2(C2) compares per lane
    (C2 = C padded to a power of two), each over the num_keys key words
    and the row position at 3 int32 operations per word (two loads'
    compare and a select)."""
    C2 = 1 << max(1, (C - 1).bit_length())
    compares = L * C2 * (C2.bit_length() - 1)
    return bound(8 * n_ops * L * C, compares * 3 * (nk + 1))


def backward_bound(K, n, W, D):
    """K2: its 11 input planes (9 B per edge, 20 B per node), 4 output
    planes (10 B per node) and the carries' initial rows, each byte once;
    the int32 operations of csrc/backward.cu's sweep_layer, 14 per edge
    and 30 per node."""
    C = W * D
    return bound(K * n * (9 * C + 30 * W) + K * (8 * W + 4), K * n * (14 * C + 30 * W))


def sort_case(torch, gen, L, C, nk, npay, dev, ties=False):
    """Operands shaped like the engine's sorts: a 0/1 validity key, wide
    keys, a unique final key (-idx), random payloads; with `ties` every
    key is drawn from {0, 1} and none is unique; with ties="prefix" the 12
    keys a record carries (ops/sort.py PREFIX_WORDS) are drawn from {0, 1}
    and the others from [-3, 3), so rows tie on the carried words and
    differ later."""
    ri = lambda lo, hi: torch.randint(lo, hi, (L, C), generator=gen, device=dev,
                                      dtype=torch.int32)
    pay = [ri(-(1 << 20), 1 << 20) for _ in range(npay)]
    if ties == "prefix":
        return [ri(0, 2) for _ in range(min(nk, 12))] + [ri(-3, 3) for _ in range(nk - 12)] + pay
    if ties:
        return [ri(0, 2) for _ in range(nk)] + pay
    keys = [ri(0, 2)] + [ri(-5000, 5000) for _ in range(max(0, nk - 2))]
    keys.append(-torch.argsort(torch.rand((L, C), generator=gen, device=dev), dim=1)
                .to(torch.int32))
    return keys[-nk:] + pay


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


# K1's cases: (label, lanes, rows, keys, payloads[, ties[, route]]), the
# route `lane_sort_route`'s unless given.  The main paths' sorts, then each
# route's boundaries.
K1_CASES = [
    ("sort1", K_LANES, WIDTH * 2, 4, 4),
    ("sort2", K_LANES, WIDTH * 2, 4, 0),
    # MISP at 200 vertices: 7 state words
    ("misp_sort1", K_LANES, WIDTH * 2, 10, 11),
    ("misp_sort2", K_LANES, WIDTH * 2, 11, 0),
    # max2sat and max-cut at 16 variables: 16 state words, one ranking column
    ("small_sort1", SMALL_BATCH, SMALL_W * 2, SMALL_N + 3, 3),
    ("small_sort2", SMALL_BATCH, SMALL_W * 2, 4, 0),
    ("non_pow2", 16, 300, 3, 2),
    ("one_lane", 1, WIDTH * 2, 4, 4),
    ("rows_32", K_LANES, 32, 4, 4),
    ("rows_64", K_LANES, 64, 4, 4),
    ("rows_2048", K_LANES, 2048, 4, 4),
    ("keys_9", 16, 300, 9, 2),
    # the new models' sorts at full width, past one block's shared memory:
    # TSPTW N60 (8 state words, dominance on), SOP with 380 jobs in one
    # lane, SRFLP n=60 (70 operands), LCS with 10 strings x 20 letters
    ("tsptw_sort1", K_LANES, WIDTH * TSPTW_N, 11, 7),
    ("tsptw_sort2", K_LANES, WIDTH * TSPTW_N, 4, 0),
    ("sop380_sort1", 1, WIDTH * 380, 39, 3),
    ("srflp60_sort1", 16, 64 * 60, 67, 3),
    ("lcs10x20_sort1", K_LANES, WIDTH * 21, 13, 15),
    # past 128 operands (phase 16's compiles, 4 lanes): max2sat at 135
    # variables, W=32 ("perm") and W=256 ("merge"), 141 operands, and at
    # 220 (226 operands), W=32
    ("max2sat135_w32", 4, 32 * 2, WIDE_N + 3, 3),
    ("max2sat135_w256", 4, WIDTH * 2, WIDE_N + 3, 3),
    ("max2sat220_w32", 4, 32 * 2, WIDE_N2 + 3, 3),
    # keys that tie on the 12 words a record carries and differ later
    ("prefix_ties_perm", 16, 300, 16, 2, "prefix"),
    ("prefix_ties_merge", 8, 20_000, 16, 2, "prefix"),
    # the "merge" route's boundaries (ops/sort.py merge_plan): one row;
    # lanes of 1,023-1,025 rows (one tile); 8 lanes of 2,049 rows (tiles of
    # 2,048, the second of one row, and windows of 256); 128 lanes of 4,096
    # rows (one tile) and of 4,097 (tiles of 4,096, windows of 2,048); rows
    # not a power of two; keys in {0, 1}
    ("merge_rows_1", 4, 1, 3, 2, False, "merge"),
    ("merge_rows_1023", 8, 1023, 11, 7, False, "merge"),
    ("merge_rows_1024", 8, 1024, 11, 7, False, "merge"),
    ("merge_rows_1025", 8, 1025, 11, 7, False, "merge"),
    ("merge_rows_2049", 8, 2049, 11, 7),
    ("merge_tile_4096", K_LANES, 4096, 11, 7),
    ("merge_tile_4097", K_LANES, 4097, 11, 7),
    ("merge_rows_50000", 8, 50_000, 11, 7),
    ("merge_ties", 8, 20_000, 6, 4, True),
    # "perm" at 12 keys up to 1,024 rows, and one row past it
    ("perm_rows_1024", 8, 1024, 12, 3),
    ("perm_rows_1025", 8, 1025, 12, 3),
    # a shape both "perm" and "merge" took before this route table
    ("perm_or_merge", K_LANES, 4096, 9, 2),
    # one lane at the networks' longest: the route table's lane count
    ("one_lane_2048", 1, 2048, 4, 4),
    ("one_lane_1024_k11", 1, 1024, 11, 7),
    # the device loop's two slab sorts, one lane of 8,192 rows: the pop sort
    # (ineligible, -ub, -value, slot) and the dedup sort at MISP-60's two
    # state words (inactive, depth, 2 words, -value, slot)
    ("slab_pop", 1, DL_SLAB, 4, 0),
    ("slab_dedup", 1, DL_SLAB, 6, 0),
]
#: the cases whose host time per call is measured (phase 2): the knapsack
#: sorts, 4 keys, and one call past 128 operands (the 12 KB struct)
K1_HOST_TIMED = ("sort1", "sort2", "max2sat135_w32")


def host_us(torch, fn, reps=200):
    """Host time per call (us): `reps` calls queued behind a ~0.2 s device
    spin, so that none waits on the device, timed on the host's clock."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def tree_kernels(root):
    """The K1 and K2 wrappers (`ddo_tpu_torch/ops/sort.py`,
    `ddo_tpu_torch/engine/backward.py`) of another checkout at `root`,
    e.g. a parent commit unpacked with `git archive`, built from that
    checkout's own `csrc/` into its own `build/` (one nvcc per source,
    started together), beside this checkout's, so that phase 2 can time
    both in turns.  A checkout whose K2 has no `backward_plan`, which
    names the route the parent takes, is refused."""
    import importlib.util
    import os

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(name, os.path.join(root, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    cb = load("parent_cuda_build", "ddo_tpu_torch/utils/cuda_build.py")
    srt = load("parent_sort", "ddo_tpu_torch/ops/sort.py")
    bwd = load("parent_backward", "ddo_tpu_torch/engine/backward.py")
    if not hasattr(bwd, "backward_plan"):
        raise RuntimeError(
            f"--parent {root}: its K2 wrapper (ddo_tpu_torch/engine/backward.py) has no "
            "backward_plan, which phase 2 reads to name the route the parent takes; only "
            "a tree that has it can be timed here")
    srt.cuda_build = bwd.cuda_build = cb
    cb.build("lane_sort", "backward")
    return srt, bwd


def phase_kernels(torch, dev, extra_k1=(), parent=None):
    """Phase 2: K1 and K2 against their plain versions on the card (K1
    also at the `extra_k1` cases, the small models' sorts).  Every route
    of either kernel that takes a case is checked and timed, in turns
    (and, given `parent`, another checkout's K1 and K2 wrappers from
    `tree_kernels`, on the route each would choose, first and last).
    Returns {(kernel, case): row}, each row the case's JSON line."""
    from ddo_tpu_torch.engine import backward as bwd
    from ddo_tpu_torch.ops import sort as srt

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = {}
    cases = K1_CASES + list(extra_k1)
    if len({c[0] for c in cases}) != len(cases):
        raise AssertionError("two K1 cases share a label")
    for label, L, C, nk, npay, *opt in cases:
        ties, forced = (list(opt) + [False, None])[:2]
        ops = sort_case(torch, gen, L, C, nk, npay, dev, ties)
        ref = srt.multi_sort_plain(ops, nk)
        route = forced or srt.lane_sort_route(nk, C, L)
        # every route is stable, so each gives the plain version's
        # payload order under tied keys too
        routes = [route] + [r for r in srt.ROUTES if r != route and srt._fits(r, nk, C)]
        err = 0
        for r_ in routes:
            got = srt.multi_sort_cuda(ops, nk, route=r_)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(torch, ref, got))
            if err or not all(torch.equal(r, g) for r, g in zip(ref, got)):
                raise AssertionError(f"K1 {label} ({r_}) disagrees with its plain version")
        calls = {r_: (lambda r_=r_: srt.multi_sort_cuda(ops, nk, route=r_)) for r_ in routes}
        if parent is not None and nk + npay <= parent[0].MAX_OPERANDS:
            parent_route = parent[0].lane_sort_route(nk, C)
            calls = {"parent": lambda: parent[0].multi_sort_cuda(ops, nk, route=parent_route),
                     **calls}
        # in turns (a, b, ..., b, a), so that all come from one card
        ms = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            ms[k].append(time_ms(torch, calls[k], 50))
        plain_ms = time_ms(torch, lambda: srt.multi_sort_plain(ops, nk), 20)
        b_ms, b_by = sort_bound(L, C, nk, nk + npay)
        new_ms = sum(ms[route]) / len(ms[route])
        row = {"phase": "kernel", "kernel": "lane_sort", "case": label, "route": route,
               "shape": [L, C], "keys": nk, "payloads": npay, "ties": ties,
               "max_abs_err": err, "ms": new_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "share_of_bound": b_ms / new_ms}
        for r_ in routes[1:]:
            row[f"{r_}_route_ms"] = sum(ms[r_]) / len(ms[r_])
        if "merge" in routes:
            row["merge_plan"] = list(srt.merge_plan(L, C, nk))
        if "parent" in calls:
            row.update(parent_route=parent_route,
                       parent_ms=sum(ms["parent"]) / len(ms["parent"]))
        if label in K1_HOST_TIMED:
            # the host's cost per call, parameter struct included, in turns
            host = {k: [] for k in calls}
            for k in list(calls) + list(calls)[::-1]:
                host[k].append(host_us(torch, calls[k]))
            row["host_us"] = sum(host[route]) / len(host[route])
            if "parent" in calls:
                row["parent_host_us"] = sum(host["parent"]) / len(host["parent"])
        rows[("lane_sort", label)] = row
        log(json.dumps(row))
        del ops, ref, got
    for label, K, n, W, D, reps in K2_CASES:
        rows[("fused_backward", label)] = backward_row(torch, gen, dev, bwd, label, K, n, W, D,
                                                        reps, parent)
    return rows


def k3_bytes(part, args):
    """The bytes K3's part `part` must read and write for one layer, each
    once: every [K, C] or [K, W] row it reads in full, the W rows of
    sort-2's first operands and of the gathers it takes through them, the
    rows it reads only for some candidates (the relaxed lanes' kept keys,
    the merged edges' relaxed costs, the pruned edges' thetas) for those
    alone, one row of each layer plane it writes, and its outputs."""
    nb = lambda x: 0 if x is None else x.numel() * x.element_size()
    if part == "remap":
        (t,) = args
        ins = [t[k] for k in ("neg_order", "surv", "head", "perm", "pruned", "pci", "ptheta")]
        return sum(map(nb, ins)) + 14 * t["surv"].numel()
    if part == "edges":
        i, t, a, merged_key, rcost, layer, P, E, lel, overflow = args
        K, C = t["surv"].shape
        W = layer["val"].shape[1]
        relax = t["need_relax"][:, None]
        code, f_valid = a.e_code, t["f_valid"]
        full = [a.e_code, f_valid, t["f_cost"]]
        # a relaxed lane reads `kept` in full and the keys of its kept rows
        # (at most W) to find the merged node's twin
        some = int(relax.sum()) * C + 4 * int((a.kept & relax).sum()) * merged_key.shape[1]
        if rcost is not None:  # the merged edges' relaxed costs
            some += 4 * int((f_valid & ((code & (1 << 28)) != 0) & relax).sum())
        if P.get("eptheta") is not None:  # the pruned edges' thetas
            some += 4 * int((f_valid & ((code & (1 << 29)) != 0)).sum())
        # W rows: sort-2's first three operands, perm, slot_exact, skip_s,
        # f_dval through them; the layer's rows
        at_w = 4 * 4 + 1 + (1 if t.get("skip_s") is not None else 0) + 4
        planes = sum(nb(x) for x in layer.values())
        written = 9 * C + (4 if P.get("eptheta") is not None else 0) * W + W  # E, eptheta, hic
        return (sum(map(nb, full)) + some + K * W * at_w + 2 * planes + K * written
                + 21 * K * W)
    i, nxt, w_dkey, w_dcoord, use_value, c_ebp, cur = args
    K, W = nxt.valid.shape
    return (sum(nb(x) for x in nxt) - nb(nxt.fidx) - nb(nxt.fresh) + nb(w_dkey)
            + nb(w_dcoord) + nb(c_ebp) + sum(nb(x) for k, x in cur.items() if k != "state"))


# K3's cases: (label, lanes, W, layer recorded).  The benchmark cells'
# one-lane shapes, then each path's own compile (`K3_OF_PATH`), then the
# widest shapes K1 is checked at that no path compiles.  A case records a
# layer no deeper than half its instance's variables.
K3_CASES = [
    ("kp", 1, WIDTH, 50),  # kp-uncorr-n100
    ("tsptw", 1, WIDTH, 10),  # tsptw-n20w40
    ("kp2000", K_LANES, WIDTH, 50),
    ("misp200", K_LANES, WIDTH, 50),
    ("max2sat16", SMALL_BATCH, SMALL_W, 8),
    ("mcp16", SMALL_BATCH, SMALL_W, 8),
    ("tsptw60", K_LANES, WIDTH, 10),
    *[(f"{name}_small", SMALL_MODELS_BATCH, SMALL_MODELS_W, 4)
      for name in ("sop", "srflp", "lcs", "psp", "alp")],
    ("misp60", K_LANES, WIDTH, 20),
    ("native_kp", NATIVE_BATCH, NATIVE_W, 50),
    ("cli_kp", CLI_BATCH, CLI_W, 25),
    ("max2sat135_w256", 4, WIDTH, 20),
    ("mesh_misp60", K_LANES // 2, WIDTH, 20),
    ("tutorial", TUTORIAL_LANES, TUTORIAL_W, 7),
    ("sop380", 1, WIDTH, 6),
    ("lcs10x20", K_LANES, WIDTH, 20),
    ("srflp60", 16, 64, 20),
]
# each path's K3 case: its own compile's model, instance, lanes and W
K3_OF_PATH = dict(knapsack="kp2000", misp="misp200", max2sat="max2sat16", mcp="mcp16",
                  tsptw="tsptw60", tsptw_search="tsptw60", sop="sop_small",
                  srflp="srflp_small", lcs="lcs_small", psp="psp_small", alp="alp_small",
                  device_loop="misp60", native="native_kp", cli="cli_kp",
                  wide="max2sat135_w256", mesh="mesh_misp60", tutorial="tutorial")


def k3_bundle(tt, label, models, tut):
    """(bundle, dominance or None) of K3's case `label`, built as the
    phase that compiles it builds them (`models`: `small_models`; `tut`:
    the loaded tutorial)."""
    from ddo_tpu_torch.models import knapsack as kp, lcs as lc, max2sat as ms, mcp as mc
    from ddo_tpu_torch.models import sop as so, srflp as sr, tsptw as ts

    knap = lambda pb: (tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()), kp.KPDominance())
    if label == "kp":
        return knap(kp.generate_uncorrelated(100, 1000, 50, 100, seed=SEED))
    if label == "kp2000":
        return knap(kp.generate_uncorrelated(N_ITEMS, 1000, 1, 100, SEED))
    if label in ("native_kp", "cli_kp"):
        args = NATIVE_KP if label == "native_kp" else CLI_KP
        return knap(kp.generate_uncorrelated(*args[:4], seed=args[4]))
    if label in ("tsptw", "tsptw60"):
        pb = (ts.generate_random(TSPTW_SMALL_N, SEED, window=40.0) if label == "tsptw"
              else ts.generate_random(TSPTW_N, SEED, window=TSPTW_WINDOW))
        return tt.ModelBundle(pb, ts.TsptwRelax(pb), ts.TsptwRanking()), ts.TsptwDominance()
    if label == "misp200":
        return misp_bundle(tt, MISP_N, MISP_P, SEED)[0], None
    if label in ("misp60", "mesh_misp60"):
        return misp_bundle(tt, DL_N, DL_P, SEED)[0], None
    if label in ("max2sat16", "max2sat135_w256"):
        pb, _ = (ms.generate_random(SMALL_N, 60, SEED) if label == "max2sat16"
                 else ms.generate_random(WIDE_N, 3 * WIDE_N, SEED))
        return tt.ModelBundle(pb, ms.Max2SatRelax(pb), ms.Max2SatRanking()), None
    if label == "mcp16":
        pb, _ = mc.generate_random(SMALL_N, 0.5, SEED)
        return tt.ModelBundle(pb, mc.McpRelax(pb), mc.McpRanking()), None
    if label.endswith("_small"):
        return models[label[:-len("_small")]][:2]
    if label == "tutorial":
        return tutorial_bundle(tt, tut), None
    if label == "sop380":
        pb = so.generate_random(380, SEED)
        return tt.ModelBundle(pb, so.SopRelax(pb), so.SopRanking()), None
    if label == "lcs10x20":
        pb = lc.generate_random(10, 20, 60, SEED)
        return tt.ModelBundle(pb, lc.LcsRelax(pb), lc.LcsRanking()), lc.LcsDominance()
    if label == "srflp60":
        pb = sr.generate_random(60, SEED)
        return tt.ModelBundle(pb, sr.SrflpRelax(pb), sr.SrflpRanking()), None
    raise ValueError(f"no K3 case {label}")


def phase_k3(torch, dev, models, tut):
    """Phase 2b: K3's three parts against their plain versions at every
    case of `K3_CASES`, on one layer's arguments recorded from an eager
    relaxed compile of the case's own model and instance on the card, K
    root lanes at W.  Returns {(kernel, case): row}."""
    import ddo_tpu_torch as tt

    from ddo_tpu_torch.engine import layer_tail as lt, mdd

    class Recorded(Exception):
        pass

    def eager(spec, inputs, start):
        layers = mdd._Layers(spec, inputs)
        layers.begin(start)
        return layers

    def clone(x):
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, tuple):
            vals = [clone(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x.clone() if torch.is_tensor(x) else x

    rows = {}
    for label, K, W, at in K3_CASES:
        bundle, dom = k3_bundle(tt, label, models, tut)
        at = min(at, bundle.problem.nb_variables // 2)
        calls, seen = {}, [0]
        parts = {p: getattr(lt, p) for p in lt.PARTS}

        def record(p):
            def run(*args):
                if seen[0] == at:
                    calls[p] = clone(args)
                out = parts[p](*args)
                if p == "dominance":
                    seen[0] += 1
                    if p in calls:
                        raise Recorded()
                return out
            return run

        saved = mdd._layers, {p: getattr(lt, p) for p in lt.PARTS}
        mdd._layers = eager
        for p in lt.PARTS:
            setattr(lt, p, record(p))
        try:
            c = tt.DDCompiler(bundle, W, dominance=dom, device=dev)
            c.compile_batch(tt.CompilationType.RELAXED, [tt.root_subproblem(bundle.problem)] * K,
                            tt.NEG_INF, [W] * K)
            raise AssertionError(f"K3 {label}: the compile ended before layer {at}")
        except Recorded:
            pass
        finally:
            mdd._layers = saved[0]
            for p in lt.PARTS:
                setattr(lt, p, saved[1][p])
        torch.cuda.synchronize()
        # each part on copies of its buffers: the kernel's and the plain
        # version's outputs and buffers bit-equal
        out = {}
        for p in lt.PARTS:
            args = calls[p]
            kern, plain = getattr(lt, p + "_cuda"), getattr(lt, p + "_plain")
            a1, a2 = clone(args), clone(args)
            got, ref = kern(*a1), plain(*a2)
            torch.cuda.synchronize()
            if not trees_equal(torch, (got, a1), (ref, a2)):
                raise AssertionError(f"K3 {p} at {label} disagrees with its plain version")
            ms = [time_ms(torch, lambda: kern(*a1), 200) for _ in range(2)]
            plain_ms = time_ms(torch, lambda: plain(*a2), 20)
            b_ms, _ = bound(k3_bytes(p, args), 0)
            out[p] = {"ms": sum(ms) / 2, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bytes": k3_bytes(p, args)}
        Kk = calls["edges"][1]["kv"].shape[2]
        del calls, a1, a2  # the recorded planes: up to ~1 GB a copy
        total = {k: sum(v[k] for v in out.values()) for k in ("ms", "plain_ms", "bound_ms")}
        row = {"phase": "kernel", "kernel": "layer_tail", "case": label,
               "model": type(bundle.problem).__name__, "shape": [K, W * bundle.problem.domain_size],
               "W": W, "D": bundle.problem.domain_size, "Kk": Kk, "layer": at,
               "dominance": dom is not None, "max_abs_err": 0, "parts": out, **total,
               "bound_by": "bytes", "share_of_bound": total["bound_ms"] / total["ms"]}
        rows[("layer_tail", label)] = row
        log(json.dumps(row))
    return rows


def trees_equal(torch, a, b):
    """Every tensor leaf of two trees (dicts, tuples) equal in dtype, shape
    and value."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(trees_equal(torch, x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


# K2's cases: (label, lanes, layers, W, D, timed calls).  The main paths'
# sweeps, fewer layers than a ring block, the high-branching models at
# real width, and the widths no bulk copy takes or that pass two layers.
K2_CASES = [
    ("main", K_LANES, N_ITEMS, WIDTH, 2, 10),
    ("one_lane", 1, N_ITEMS, WIDTH, 2, 10),
    ("misp", K_LANES, MISP_N, WIDTH, 2, 20),
    ("small", SMALL_BATCH, SMALL_N, SMALL_W, 2, 50),
    # the TSPTW compile's sweep: D = 61, and the same at four lanes, at
    # one and at 60 (phase 17's first supersteps)
    ("tsptw", K_LANES, TSPTW_N, WIDTH, TSPTW_N, 10),
    ("tsptw_4lanes", 4, TSPTW_N, WIDTH, TSPTW_N, 20),
    ("tsptw_1lane", 1, TSPTW_N, WIDTH, TSPTW_N, 20),
    ("tsptw_60lanes", 60, TSPTW_N, WIDTH, TSPTW_N, 20),
    # SOP with 380 jobs in one lane, SRFLP n=60 at 16 lanes (K1's rows
    # 1f and 1g), W=256
    ("sop380", 1, 380, WIDTH, 380, 5),
    ("srflp60", 16, 60, WIDTH, 60, 20),
    # the small models' maximize sweeps
    ("small_models", SMALL_MODELS_BATCH, 8, SMALL_MODELS_W, 9, 50),
    # the device loop's, NativeSolver's and the CLI's sweeps
    ("dl_misp60", K_LANES, DL_N, WIDTH, 2, 20),
    ("native_kp", NATIVE_BATCH, NATIVE_KP[0], NATIVE_W, 2, 50),
    ("cli_kp", CLI_BATCH, CLI_KP[0], CLI_W, 2, 50),
    # the mesh's MISP shards (phase 18: 128 lanes over two entries) and the
    # tutorial's sweep (phase 19)
    ("mesh_misp60", K_LANES // 2, DL_N, WIDTH, 2, 20),
    ("tutorial", TUTORIAL_LANES, TUTORIAL_N, TUTORIAL_W, 2, 50),
    # phase 16's max2sat at 135 variables, W=256
    ("wide_max2sat", 4, WIDE_N, WIDTH, 2, 20),
    ("layers_3", K_LANES, 3, WIDTH, 2, 50),
    ("width_1100", 8, 50, 1100, 3, 20),
    ("direct", 4, 50, 4096, 2, 20),
]


def backward_row(torch, gen, dev, bwd, label, K, n, W, D, reps, parent):
    """One K2 case: every route that takes it ("tma" where two layers fit,
    "stream" where rows are 16-byte multiples, and at one CTA per lane too
    where its plan spreads a lane over a cluster, and with one node pass
    in flight where its plan keeps more, "direct" always) held bit-equal
    to `backward_scans` and timed in turns (a, b, ..., b, a), the parent's
    K2 first and last; the plan's route first."""
    args = backward_case(torch, gen, K, n, W, D, dev)
    ref = bwd.backward_scans(*args)
    plan = bwd.backward_plan(K, W, D)
    forced = {plan.route: {}}
    for r in bwd.ROUTES:
        try:
            other = bwd.backward_plan(K, W, D, r)
        except ValueError:
            continue
        forced.setdefault(r, {"route": r})
        if r == "stream" and other.cluster > 1:
            forced["stream_c1"] = {"route": "stream", "cluster": 1}
        if r == "stream" and other.unroll > 1:
            forced["stream_u1"] = {"route": "stream", "unroll": 1}
    err = 0
    for name, kw in forced.items():
        got = bwd.fused_backward_cuda(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(torch, ref, got))
        if err or not all(torch.equal(r, g) for r, g in zip(ref, got)):
            raise AssertionError(f"K2 {label} ({name}) disagrees with its plain version")
    calls = {name: (lambda kw=kw: bwd.fused_backward_cuda(*args, **kw))
             for name, kw in forced.items()}
    if parent is not None:
        parent_route = parent[1].backward_plan(K, W, D).route
        calls = {"parent": lambda: parent[1].fused_backward_cuda(*args), **calls}
    ms = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        ms[k].append(time_ms(torch, calls[k], reps))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    plain_ms = time_ms(torch, lambda: bwd.backward_scans(*args), 2)
    b_ms, b_by = backward_bound(K, n, W, D)
    row = {"phase": "kernel", "kernel": "fused_backward", "case": label, "route": plan.route,
           "cluster": plan.cluster, "block": plan.block, "depth": plan.depth,
           "group": plan.group, "unroll": plan.unroll, "threads": plan.threads,
           "shape": [K, n, W, D],
           "max_abs_err": err, "ms": mean[plan.route], "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / mean[plan.route]}
    for k in forced:
        if k != plan.route:
            row[f"{k}_route_ms"] = mean[k]
    if parent is not None:
        row.update(parent_route=parent_route, parent_ms=mean["parent"],
                   parent_ms_turns=ms["parent"], ms_turns=ms[plan.route])
    log(json.dumps(row))
    return row


#: the "stream" planner's constants (engine/backward.py) and the values
#: `sweep_k2` tries; the cases of K2_CASES it tries them on
K2_SWEEP = {"STREAM_MIN_DEPTH": (2, 3, 4, 6), "STREAM_MAX_DEPTH": (3, 6, 32),
            "STREAM_WARPS": (4, 8, 16), "STREAM_PASSES": (1, 2, 4)}
K2_SWEEP_CASES = ("tsptw", "tsptw_1lane", "tsptw_4lanes", "sop380", "srflp60", "direct")


def sweep_k2(torch, dev):
    """`--sweep-k2`: K2's "stream" route at K2_SWEEP_CASES under every
    combination of K2_SWEEP's planner constants.  Each distinct plan is
    held bit-equal to `backward_scans` and timed in turns (a, b, ..., b,
    a); one line per case: the planner's plan and time, then each plan's
    constants and time, fastest first."""
    from ddo_tpu_torch.engine import backward as bwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    saved = {k: getattr(bwd, k) for k in K2_SWEEP}

    def use(consts):
        for k, v in consts.items():
            setattr(bwd, k, v)

    try:
        for label, K, n, W, D, reps in K2_CASES:
            if label not in K2_SWEEP_CASES:
                continue
            args = backward_case(torch, gen, K, n, W, D, dev)
            ref = bwd.backward_scans(*args)
            plans = {}
            for values in itertools.product(*K2_SWEEP.values()):
                consts = dict(zip(K2_SWEEP, values))
                use(consts)
                try:
                    plans.setdefault(bwd.backward_plan(K, W, D, "stream"), consts)
                except ValueError:
                    continue
            use(saved)
            chosen = bwd.backward_plan(K, W, D, "stream")
            calls = {}
            for plan, consts in plans.items():
                use(consts)
                got = bwd.fused_backward_cuda(*args, route="stream")
                torch.cuda.synchronize()
                if not all(torch.equal(r, g) for r, g in zip(ref, got)):
                    raise AssertionError(f"K2 {label} disagrees with its plain version "
                                         f"under {consts}")
                calls[plan] = (lambda consts=consts: (
                    use(consts), bwd.fused_backward_cuda(*args, route="stream")))
            ms = {p_: [] for p_ in calls}
            for p_ in list(calls) + list(calls)[::-1]:
                ms[p_].append(time_ms(torch, calls[p_], reps))
            use(saved)
            mean = {p_: sum(v) / len(v) for p_, v in ms.items()}
            fields = lambda p_: {"block": p_.block, "depth": p_.depth, "cluster": p_.cluster,
                                 "unroll": p_.unroll, "threads": p_.threads}
            log(json.dumps({"phase": "sweep_k2", "case": label, "shape": [K, n, W, D],
                            "planner": fields(chosen), "planner_ms": mean[chosen],
                            "planner_ms_turns": ms[chosen],
                            "plans": [{**fields(p_), **plans[p_], "ms": mean[p_],
                                       "ms_turns": ms[p_]}
                                      for p_ in sorted(mean, key=mean.get)]}))
    finally:
        use(saved)


def knapsack_depth_lanes(tt):
    """A 60-item knapsack's bundle and 3 lanes rooted at depths 0, 7 and 20
    (the deeper two at half the capacity)."""
    import numpy as np

    from ddo_tpu_torch.models import knapsack as kp

    small = kp.generate_uncorrelated(60, 1000, 1, 20, SEED + 1)
    root = tt.root_subproblem(small)
    subs = [root]
    for depth in (7, 20):
        pset = np.zeros(small.nb_variables, bool)
        pset[:depth] = True
        state = {"capacity": np.asarray(small.capacity // 2, np.int32)}
        subs.append(dataclasses.replace(root, state=state, value=100 * depth,
                                        path_set=pset, depth=depth))
    return tt.ModelBundle(small, kp.KPRelax(small), kp.KPRanking()), subs


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
    # Run twice on the same lanes: with the solver's default extraction on
    # the card (the rows selected on the device, `engine/extract.py`) and
    # with the plane route (whole planes to the host, rows selected there).
    for compact in (True, False):
        solver = tt.SequentialSolver(
            tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()), width_heu=tt.FixedWidth(W),
            cache=tt.SimpleCache(), fringe=tt.NoDupFringe(), batch=K, device=dev,
            dominance=tt.SimpleDominanceChecker(kp.KPDominance(), pb.nb_variables))
        if not solver._compact:
            raise AssertionError("the compact extraction is not the card's default")
        solver._compact = compact
        solver.cache.initialize(pb)
        solver.dominance.prime(pb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solver._process_batch_fused(roots, [W] * K)
        solver._clock.stop()  # ends the superstep's last phase
        st = solver.stats
        if solver.best_lb > opt or (len(solver.fringe) == 0 and solver.best_lb != opt):
            raise AssertionError(f"superstep incumbent {solver.best_lb} vs optimum {opt}")
        log(json.dumps({"phase": "superstep", "extraction": "compact" if compact else "plane",
                        "lanes": K, "n": n, "width": W,
                        "expanded": solver.expanded_nodes, "compile_s": st.compile_s,
                        "extraction_s": st.extract_s, "absorb_s": st.absorb_s,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "incumbent": solver.best_lb, "fringe": len(solver.fringe)}))
        del solver

    # the whole engine on the device against the CPU path (which the CPU
    # tests hold against ddo_tpu), every plane, on a small instance with
    # lanes rooted at different depths
    sb, subs = knapsack_depth_lanes(tt)
    subs = subs[:1] + subs  # the root twice
    dom = kp.KPDominance()
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
    from ddo_tpu_torch.models import knapsack as kp

    before = launch_counts()
    sol = tt.maximize(pb, kp.KPRelax(pb), kp.KPRanking(), use_cache=True, width=W,
                      batch=batch,
                      dominance=tt.SimpleDominanceChecker(kp.KPDominance(),
                                                          pb.nb_variables),
                      device=dev)
    if sol.aborted or sol.gap != 0 or sol.objective != opt:
        raise AssertionError(f"maximize: {sol} vs DP optimum {opt}")
    # K2 runs once per pass: two per superstep
    launches, _ = launches_since(before)
    log(json.dumps({"phase": "solve", "n": pb.nb_variables, "width": W,
                    "batch": batch, "optimum": opt, "objective": sol.objective,
                    "gap": sol.gap, "time_to_optimum_s": sol.duration,
                    "lane_sort_launches": launches["lane_sort"],
                    "fused_backward_launches": launches["fused_backward"]}))
    return sol


def nbytes(tree):
    """Bytes of every numpy array in a tree of dicts."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return getattr(tree, "nbytes", 0)


def misp_bundle(tt, n, p, seed):
    from ddo_tpu_torch.models import misp as mi

    pb, edges = mi.generate_gnp(n, p, seed)
    return tt.ModelBundle(pb, mi.MispRelax(pb), mi.MispRanking(pb)), edges


def check_independent_set(edges, weight, assignment, value, what):
    """`assignment` (1 = taken) is an independent set of weight `value`."""
    taken = {v for v, d in enumerate(assignment) if d == 1}
    for a, b in edges:
        if a in taken and b in taken:
            raise AssertionError(f"{what}: edge {a}-{b} inside the set")
    if sum(int(weight[v]) for v in taken) != value:
        raise AssertionError(f"{what}: the set's weight is not {value}")


def phase_misp_compile(torch, dev, n=MISP_N, p=MISP_P, K=K_LANES, W=WIDTH):
    """Phase 6: the MISP path at real size.  Two solvers share every
    compiled batch: one absorbs it by the compact route (rows selected on
    the device), the other by the plane route (whole planes to the host),
    and both must end with the same rows, cache and fringe."""
    import numpy as np

    import ddo_tpu_torch as tt

    bundle, edges = misp_bundle(tt, n, p, SEED)
    pb = bundle.problem
    make = lambda: tt.SequentialSolver(bundle, width_heu=tt.FixedWidth(W), batch=K,
                                       cache=tt.SimpleCache(), device=dev)
    compact, plane = make(), make()
    if dev.type == "cuda" and not compact._compact:
        raise AssertionError("the compact extraction is not the card's default")
    compact._compact, plane._compact = True, False
    for s in (compact, plane):
        s.cache.initialize(pb)
    roots = [tt.root_subproblem(pb)] * K

    def absorb(solver, batch, relaxed):
        """The solver's own extraction of one pass, timed."""
        t0 = time.perf_counter()
        ex = solver._extract_batch(batch, want_cutset=relaxed) if solver._compact else None
        if relaxed:
            solver._absorb_relaxed(list(zip(roots, batch)), roots, batch, ex)
        else:
            for dd in batch:
                solver._maybe_update_best(dd)
                if ex is None:
                    solver._apply_cache_updates(dd)
            if ex is not None:
                solver._apply_cache_compact(ex)
        return ex, time.perf_counter() - t0

    var_of, best = {}, {}
    for label, comp in [("restricted", tt.CompilationType.RESTRICTED),
                        ("relaxed", tt.CompilationType.RELAXED)]:
        relaxed = label == "relaxed"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batch = compact.compiler.compile_batch(comp, roots, tt.NEG_INF, [W] * K)
        expanded = batch.total_expanded  # waits for the device
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # the compact route first, then the plane route on a view of the
        # same batch that has brought nothing to the host yet; nothing else
        # reads either view before its bytes are counted, so each route's
        # time covers every byte its count reports.  Where the cutset
        # overflows its cap the compact route falls back to the plane
        # route's cutset, and its bytes count the planes that took.
        ex, compact_s = absorb(compact, batch, relaxed)
        compact_bytes = nbytes(ex) + nbytes(batch._planes._np)
        cold = compact.compiler._batch(batch.spec, roots, batch.dev, batch.actives)
        _, plane_s = absorb(plane, cold, relaxed)
        plane_bytes = nbytes(cold._planes._np)
        best[label] = [dd.best_value() for dd in cold]
        if not relaxed:
            for k in (0, K - 1):
                vals, _ = cold[k].best_solution()
                check_independent_set(edges, pb.weight, vals, best[label][k],
                                      f"restricted lane {k}")
        # the same rows in the same order as the plane route's, lane by lane
        lanes = [dd.cache_batch() for dd in cold]
        m = len(ex["cache"]["depths"])
        if sum(len(l[0]) for l in lanes) != ex["cache"]["count"]:
            raise AssertionError(f"{label}: compact cache count differs")
        for i, name in enumerate(("depths", "keys", "thetas", "explored")):
            if not np.array_equal(np.concatenate([l[i] for l in lanes])[:m],
                                  ex["cache"][name]):
                raise AssertionError(f"{label}: compact cache rows differ in {name}")
        cut_rows, fell_back = 0, False
        if relaxed:
            lanes = [dd.cutset_batch() for dd in cold if not dd.is_exact()]
            cut_rows, m = ex["cut"]["count"], len(ex["cut"]["lanes"])
            fell_back = cut_rows > m
            if sum(len(l[1]) for l in lanes) != cut_rows:
                raise AssertionError("relaxed: compact cutset count differs")
            for name, i in dict(keys=0, layers=1, values=2, ubs=3, scores=6).items():
                if not np.array_equal(np.concatenate([l[i] for l in lanes])[:m],
                                      ex["cut"][name]):
                    raise AssertionError(f"relaxed: compact cutset rows differ in {name}")
        var_of[label] = batch._planes.get("var_of")
        log(json.dumps({"phase": "misp_compile", "pass": label, "lanes": K, "n": n,
                        "edges": len(edges), "width": W, "best_value": best[label][0],
                        "expanded": expanded, "wall_s": wall,
                        "ms_per_layer": 1e3 * wall / n,
                        "expansions_per_s": expanded / wall, "peak_bytes": peak,
                        "cache_rows": ex["cache"]["count"], "cutset_rows": cut_rows,
                        "cutset_cap_overflow": fell_back,
                        "compact_extraction_s": compact_s, "compact_d2h_bytes": compact_bytes,
                        "plane_extraction_s": plane_s, "plane_d2h_bytes": plane_bytes,
                        "rows_equal": True, "incumbent": compact.best_lb,
                        "fringe": len(compact.fringe)}))
        del batch
    for k in range(K):
        if best["restricted"][k] is None or best["relaxed"][k] < best["restricted"][k]:
            raise AssertionError(f"lane {k}: relaxed bound below the restricted value")
    if np.array_equal(var_of["restricted"], var_of["relaxed"]):
        raise AssertionError("the two compiles branched in one order: the dynamic "
                             "order did not follow the layers")
    # both routes leave the same solver state behind
    def drained(solver):
        nodes = []
        while len(solver.fringe):
            nd = solver.fringe.pop()
            nodes.append((nd.key, nd.ub, nd.depth, nd.value, nd.path_set.tobytes()))
        return sorted(nodes)

    a, b = drained(compact), drained(plane)
    if compact.best_lb != plane.best_lb or not a or a != b:
        raise AssertionError("compact and plane routes left different fringes")


def compile_parity(torch, dev, name, bundle, W, dominance=None, within_one=()):
    """A fused restricted + relaxed compile of 3 or 4 lanes rooted at
    different depths (the root and cutset nodes of relaxed compiles of it
    on the CPU) on the device and on the CPU: every plane equal, those in
    `within_one` within one.  Returns (row, lanes, relaxed planes)."""
    import numpy as np

    import ddo_tpu_torch as tt
    from ddo_tpu_torch.engine.mdd import sort_operands
    from ddo_tpu_torch.ops import sort as srt

    root = tt.root_subproblem(bundle.problem)
    by_depth = {}
    for cutset in (tt.FRONTIER, tt.LAST_EXACT_LAYER):
        cpu = tt.DDCompiler(bundle, W, cutset, dominance=dominance, device="cpu")
        for width in [w for w in (3, 1, 2, 4, 6, 8) if w <= W]:
            cut = sorted(cpu.compile(tt.CompilationType.RELAXED, root, tt.NEG_INF,
                                     width).drain_cutset(), key=lambda s: -s.depth)
            for d, sub in {s.depth: s for s in cut}.items():
                by_depth.setdefault(d, sub)
            if len(by_depth) >= 3:
                break
        if len(by_depth) >= 3:
            break
    subs = [root] + list(by_depth.values())[:3]
    if len({s.depth for s in subs}) < 3:
        raise AssertionError(f"{name} fixture: lanes must be rooted at different depths")
    planes = {}
    cpu = tt.DDCompiler(bundle, W, tt.FRONTIER, dominance=dominance, device="cpu")
    for c in (tt.DDCompiler(bundle, W, tt.FRONTIER, dominance=dominance, device=dev), cpu):
        rs, xs = c.compile_fused(subs, tt.NEG_INF, [3, 5, W, 4][:len(subs)])
        planes[c.device.type] = [b._planes for b in (rs, xs)]
    keys = [k for k in planes["cpu"][0]._dev if k != "state"]
    off_by_one = 0
    for a, b in zip(planes[dev.type], planes["cpu"]):
        for k in keys:
            if k in within_one:
                d = np.abs(a.get(k).astype(np.int64) - b.get(k))
                off_by_one += int((d == 1).sum())
                if d.max() > 1:
                    raise AssertionError(f"{name} plane {k} differs by {d.max()} "
                                         f"between {dev} and cpu")
            elif not np.array_equal(a.get(k), b.get(k)):
                raise AssertionError(f"{name} plane {k} differs between {dev} and cpu")
        for k, v in b.get("state").items():
            if not np.array_equal(a.get("state")[k], v):
                raise AssertionError(f"{name} state plane {k} differs between {dev} and cpu")
    nk = sort_operands(bundle, dominance)[0]
    C = W * bundle.problem.domain_size
    row = {"phase": "compile_vs_cpu", "model": name, "n": bundle.problem.nb_variables,
           "lanes": len(subs), "root_depths": [s.depth for s in subs], "width": W,
           "dominance": dominance is not None,
           "sort1": {"shape": [len(subs), C], "keys": nk,
                     "route": srt.lane_sort_route(nk, C, len(subs))},
           "planes": len(keys), "equal": True}
    if within_one:
        row.update(equal=not off_by_one, within_one=list(within_one), off_by_one=off_by_one)
    return row, subs, planes[dev.type][1]


def phase_cpu_parity(torch, dev):
    """Phase 5: small compiles on the device against the CPU path (which
    the CPU tests hold against ddo_tpu), every plane, lanes rooted at
    different depths: MISP (a dynamic order per lane, long arcs), golomb
    (a wide domain: lanes of width x 26 candidates, 9 keys, K1's "perm"
    route) and talentsched (two bitsets)."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import golomb as go, talentsched as ta

    parity = lambda *a, **k: compile_parity(torch, dev, *a, **k)
    bundle, _ = misp_bundle(tt, 40, 0.2, SEED + 1)
    row, subs, relaxed = parity("misp", bundle, 8)
    var_of = relaxed.get("var_of")
    deepest = max(s.depth for s in subs)
    if all(len(set(var_of[:, l])) == 1 for l in range(deepest, var_of.shape[1])):
        raise AssertionError("every lane branched on the same variables")
    if not relaxed.get("bs").any():
        raise AssertionError("no long arc in the MISP compile")
    log(json.dumps({**row, "lanes_differ_in_var_of": True}))

    pb = go.Golomb(7)
    row, _, _ = parity("golomb", tt.ModelBundle(pb, go.GolombRelax(pb), go.GolombRanking()), 32)
    if row["sort1"]["route"] != "perm":
        raise AssertionError(f"golomb fixture: sort-1 is to take the perm route: {row}")
    log(json.dumps(row))

    # talentsched's rough upper bound is a float32 sum rounded up: the card
    # adds in another order than the CPU, so where the sum is an integer
    # the bound may differ by one.  Both are admissible (the model adds a
    # slack); every other plane must be equal, and `maximize` on the card
    # must prove the optimum that brute force over all orders finds.
    pb = ta.generate_random(10, 4, SEED)
    row, _, _ = parity("talentsched", tt.ModelBundle(pb, ta.TalentSchedRelax(pb),
                                                     ta.TalentSchedRanking()), 16,
                       within_one=("rub",))
    log(json.dumps(row))
    pb = ta.generate_random(7, 3, SEED)
    opt = None
    for order in itertools.permutations(range(7)):
        pay = 0
        for a in range(pb.nb_actors):
            on = [i for i, s_ in enumerate(order) if pb.actor_mat[a][s_]]
            pay += int(pb.cost[a]) * sum(int(pb.duration[order[i]])
                                         for i in range(min(on), max(on) + 1))
        opt = pay if opt is None else min(opt, pay)
    sol = tt.maximize(pb, ta.TalentSchedRelax(pb), ta.TalentSchedRanking(), use_cache=True,
                      width=8, batch=4, device=dev)
    if sol.aborted or sol.gap != 0 or sol.objective != -opt:
        raise AssertionError(f"maximize(talentsched): {sol} vs exact optimum {-opt}")
    log(json.dumps({"phase": "solve", "model": "talentsched", "n": 7, "optimum": -opt,
                    "objective": sol.objective, "gap": sol.gap,
                    "time_to_optimum_s": sol.duration, "width": 8, "batch": 4}))


def exact_mis(n, edges, weight):
    """The maximum weight of an independent set, by branch and bound over
    Python-int bitmasks: branch on the candidate of largest degree, bound
    by the candidates' total weight."""
    adj = [0] * n
    for a, b in edges:
        adj[a] |= 1 << b
        adj[b] |= 1 << a

    def members(mask):
        while mask:
            low = mask & -mask
            yield low.bit_length() - 1
            mask ^= low

    best = 0

    def search(cand, value):
        nonlocal best
        rest = sum(weight[v] for v in members(cand))
        if value + rest <= best:
            return
        v = max(members(cand), key=lambda u: bin(adj[u] & cand).count("1"), default=None)
        if v is None or not adj[v] & cand:  # no edge left among the candidates
            best = value + rest
            return
        search(cand & ~adj[v] & ~(1 << v), value + weight[v])
        search(cand & ~(1 << v), value)

    search((1 << n) - 1, 0)
    return best


def phase_small_solve(torch, dev, model):
    """Phases 7 and 8: `maximize` to a proved optimum on `model` ("misp",
    "max2sat" or "mcp"), against an exact optimum computed on the host."""
    import numpy as np

    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import max2sat as ms, mcp as mc

    def solve(pb, relax, ranking, opt, **kw):
        sol = tt.maximize(pb, relax, ranking, use_cache=True, device=dev, **kw)
        if sol.aborted or sol.gap != 0 or sol.objective != opt:
            raise AssertionError(f"maximize({model}): {sol} vs exact optimum {opt}")
        log(json.dumps({"phase": "solve", "model": model, "n": pb.nb_variables,
                        "optimum": opt, "objective": sol.objective, "gap": sol.gap,
                        "time_to_optimum_s": sol.duration, **kw}))
        return sol

    if model == "misp":
        bundle, edges = misp_bundle(tt, 60, 0.2, SEED)
        pb = bundle.problem
        opt = exact_mis(60, edges, [int(w) for w in pb.weight])
        sol = solve(pb, bundle.relaxation, bundle.ranking, opt, batch=16)
        check_independent_set(edges, pb.weight, sol.assignment, opt, "maximize(misp)")
        return
    n = SMALL_N
    bits = (np.arange(1 << n)[:, None] >> np.arange(n)) & 1  # every assignment
    if model == "max2sat":
        pb, clauses = ms.generate_random(n, 60, SEED)
        sat = np.zeros(1 << n, np.int64)
        for (a, b), w in clauses.items():
            sat += w * ((bits[:, abs(a) - 1] == (a > 0)) | (bits[:, abs(b) - 1] == (b > 0)))
        solve(pb, ms.Max2SatRelax(pb), ms.Max2SatRanking(), int(sat.max()),
              width=SMALL_W, batch=SMALL_BATCH)
    else:
        pb, _ = mc.generate_random(n, 0.5, SEED)
        side = 1 - 2 * bits[bits[:, 0] == 0]  # vertex 0 pinned; +1 / -1 sides
        total = int(np.triu(pb.w, 1).sum())
        cut = (total - ((side @ pb.w) * side).sum(axis=1) // 2) // 2
        solve(pb, mc.McpRelax(pb), mc.McpRanking(), int(cut.max()), lel=False,
              width=SMALL_W, batch=SMALL_BATCH)


def tsptw_oracle(dist, twe, twl):
    """The shortest return time of a TSPTW tour (waiting allowed), by a
    forward DP over (visited set, last node) labels that keeps the
    earliest arrival of each: exact, since arriving later never helps.  A
    label dies when it misses a window, or when some node still to visit
    is out of reach even straight from here (the slack of n covers the
    truncation of scaled distances, so no feasible tour is cut)."""
    n = len(dist)
    layer = {(1, 0): 0}
    for _ in range(n - 1):
        nxt = {}
        for (mask, last), t in layer.items():
            for j in range(1, n):
                if mask >> j & 1:
                    continue
                a = max(t + int(dist[last][j]), int(twe[j]))
                m2 = mask | 1 << j
                if a > twl[j] or any(a + int(dist[j][k]) - n > twl[k]
                                     for k in range(1, n) if not m2 >> k & 1):
                    continue
                if a < nxt.get((m2, j), a + 1):
                    nxt[(m2, j)] = a
        layer = nxt
    ends = [max(t + int(dist[last][0]), int(twe[0])) for (_, last), t in layer.items()]
    ends = [a for a in ends if a <= twl[0]]
    return min(ends) if ends else None


def replay_tour(pb, vals, pset):
    """The return time of the tour `vals` (the nodes in depth order),
    checking every window on the way."""
    t, cur = 0, 0
    for j in [int(vals[d]) for d in range(pb.nb_variables) if pset[d]]:
        t = max(t + int(pb.dist[cur][j]), int(pb.twe[j]))
        if t > pb.twl[j]:
            raise AssertionError(f"tour misses the window of node {j}: {t} > {pb.twl[j]}")
        cur = j
    if cur != 0:
        raise AssertionError("the tour does not end at the depot")
    return t


def phase_tsptw_compile(torch, dev, rows, K=K_LANES, W=WIDTH, n=TSPTW_N):
    """Phase 9: the TSPTW path at full width.  A seeded 61-node instance
    of Langevin's N60 shape, 128 root lanes at W=256 with the
    zero-coordinate dominance filtering each layer: a restricted and a
    relaxed compile, each followed by the solver's extraction (the card's
    compact route).  Every lane's relaxed bound is at least its restricted
    value, a restricted tour replays within every window at its value, and
    both sorts of every layer take K1's "merge" route."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import tsptw as ts

    pb = ts.generate_random(n, SEED, window=TSPTW_WINDOW)
    bundle = tt.ModelBundle(pb, ts.TsptwRelax(pb), ts.TsptwRanking())
    solver = tt.SequentialSolver(
        bundle, width_heu=tt.TsptwWidth(n), buffer_width=W, batch=K, cache=tt.SimpleCache(),
        cutset_type=tt.LAST_EXACT_LAYER, device=dev,
        dominance=tt.SimpleDominanceChecker(ts.TsptwDominance(), n))
    if not solver._compact or solver.compiler.width != W:
        raise AssertionError("the TSPTW solver is not on the card's default route at W")
    solver.cache.initialize(pb)
    solver.dominance.prime(pb)
    roots = [tt.root_subproblem(pb)] * K
    best = {}
    for label, comp in [("restricted", tt.CompilationType.RESTRICTED),
                        ("relaxed", tt.CompilationType.RELAXED)]:
        relaxed = label == "relaxed"
        before = launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batch = solver.compiler.compile_batch(comp, roots, tt.NEG_INF, [W] * K)
        expanded = batch.total_expanded  # waits for the device
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches, by = launches_since(before)
        k1, k2 = by["lane_sort"], by["fused_backward"]
        if k1["merge"] != 2 * n or launches["lane_sort"] != 2 * n:
            raise AssertionError(f"{label}: K1 did not sort every layer on its merge route: {k1}")
        if k2 != {**{r: 0 for r in k2}, "stream": 1}:
            raise AssertionError(f"{label}: K2 did not sweep once on its stream route: {k2}")
        t0 = time.perf_counter()
        ex = solver._extract_batch(batch, want_cutset=relaxed)
        if relaxed:
            solver._absorb_relaxed(list(zip(roots, batch)), roots, batch, ex)
        else:
            for dd in batch:
                solver._maybe_update_best(dd)
            solver._apply_cache_compact(ex)
            solver._absorb_dominance_compact(ex)
        extraction = time.perf_counter() - t0
        best[label] = [dd.best_value() for dd in batch]
        if not relaxed:
            for k in (0, K - 1):
                vals, pset = batch[k].best_solution()
                if -replay_tour(pb, vals, pset) != best[label][k]:
                    raise AssertionError(f"lane {k}: the restricted tour does not cost its value")
        cut = ex.get("cut", {"count": 0, "lanes": ()})
        k1_ms = rows[("lane_sort", "tsptw_sort1")]["ms"] + rows[("lane_sort", "tsptw_sort2")]["ms"]
        log(json.dumps({
            "phase": "tsptw_compile", "pass": label, "lanes": K, "n": n, "width": W,
            "window": TSPTW_WINDOW, "best_value": best[label][0], "expanded": expanded,
            "wall_s": wall, "ms_per_layer": 1e3 * wall / n,
            "expansions_per_s": expanded / wall, "peak_bytes": peak,
            "lane_sort_launches": launches["lane_sort"], "lane_sort_routes": k1,
            "lane_sort_ms_per_layer": k1_ms,
            "fused_backward_launches": launches["fused_backward"],
            "fused_backward_routes": k2,
            "fused_backward_ms": rows[("fused_backward", "tsptw")]["ms"],
            "fused_backward_route": rows[("fused_backward", "tsptw")]["route"],
            "cache_rows": ex.get("cache", {}).get("count", 0),
            "dominance_rows": ex.get("dom", {}).get("count", 0),
            "cutset_rows": cut["count"], "cutset_cap_overflow": cut["count"] > len(cut["lanes"]),
            "extraction_s": extraction,
            "d2h_bytes": nbytes(ex) + nbytes(batch._planes._np),
            "incumbent": solver.best_lb, "fringe": len(solver.fringe)}))
        del batch, ex
    for k in range(K):
        if best["restricted"][k] is None or best["relaxed"][k] < best["restricted"][k]:
            raise AssertionError(f"lane {k}: relaxed bound below the restricted value")


def phase_tsptw_solve(torch, dev, n=TSPTW_SMALL_N, W=WIDTH, batch=16):
    """Phase 10: `maximize` on a seeded 21-node instance (the N20 class:
    lanes of 5,376 candidates, sort-1 on K1's "merge" route) at W=256 with
    the cache and the dominance store, to gap 0 and to the exact DP
    oracle's optimum; its tour replays within every window."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import tsptw as ts

    pb = ts.generate_random(n, SEED)
    opt = tsptw_oracle(pb.dist, pb.twe, pb.twl)
    sol = tt.maximize(pb, ts.TsptwRelax(pb), ts.TsptwRanking(), use_cache=True, width=W,
                      batch=batch, device=dev,
                      dominance=tt.SimpleDominanceChecker(ts.TsptwDominance(), n))
    if opt is None or sol.aborted or sol.gap != 0 or sol.objective != -opt:
        raise AssertionError(f"maximize(tsptw): {sol} vs exact optimum {opt}")
    if replay_tour(pb, sol.assignment, [True] * n) != opt:
        raise AssertionError("maximize(tsptw): the tour does not cost the optimum")
    log(json.dumps({"phase": "solve", "model": "tsptw", "n": n, "optimum": -opt,
                    "objective": sol.objective, "gap": sol.gap,
                    "time_to_optimum_s": sol.duration, "width": W, "batch": batch}))


def phase_tsptw_search(torch, dev, n=TSPTW_N, W=WIDTH, batch=K_LANES,
                       budget=TSPTW_SEARCH_S):
    """Phase 17: `SequentialSolver.maximize` on phase 9's 61-node instance
    at W=256, 128 lanes a superstep, the cache and the dominance store,
    stopped by a time budget: the search's first supersteps compile a
    lane or a few, the later ones up to 128, so K2's planner spreads
    their lanes over clusters of CTAs.  Logs the lanes of each compile
    (under a budget the solver compiles a superstep's restricted and
    relaxed passes apart, polling the budget every 32 layers, so the last
    may stop before its sweep) and K2's launches by cluster size; the
    best tour replays within every window at its value, and the bounds
    bracket it."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import tsptw as ts

    pb = ts.generate_random(n, SEED, window=TSPTW_WINDOW)
    bundle = tt.ModelBundle(pb, ts.TsptwRelax(pb), ts.TsptwRanking())
    solver = tt.SequentialSolver(
        bundle, width_heu=tt.TsptwWidth(n), buffer_width=W, batch=batch,
        cache=tt.SimpleCache(), cutoff=tt.TimeBudget(budget), device=dev,
        dominance=tt.SimpleDominanceChecker(ts.TsptwDominance(), n))
    lanes, compile_batch = [], solver.compiler.compile_batch

    def recorded(comp_type, subs, *a, **kw):
        lanes.append(len(subs))
        return compile_batch(comp_type, subs, *a, **kw)

    solver.compiler.compile_batch = recorded
    before = launch_counts()
    t0 = time.perf_counter()
    completion = solver.maximize()
    wall = time.perf_counter() - t0
    launches, by = launches_since(before)
    clusters, calls = by["stream_clusters"], launches["fused_backward"]
    value, (vals, pset) = solver.best_value(), solver.best_solution()
    if value is None or -replay_tour(pb, vals, pset) != value:
        raise AssertionError("tsptw search: the best tour does not cost its value")
    if not solver.best_lower_bound() <= solver.best_upper_bound() or completion.is_exact:
        raise AssertionError("tsptw search: the bounds do not bracket an open search")
    if sum(clusters.values()) != calls or clusters[1] == calls:
        raise AssertionError(f"tsptw search: K2 took no cluster, or another route: "
                             f"{clusters} of {calls} launches")
    log(json.dumps({"phase": "tsptw_search", "n": n, "width": W, "batch": batch,
                    "budget_s": budget, "wall_s": wall, "supersteps": solver.stats.supersteps,
                    "lanes_per_compile": lanes, "best_value": value,
                    "upper_bound": solver.best_upper_bound(),
                    "fused_backward_launches": calls, "stream_clusters": clusters,
                    "clustered_share": 1 - clusters[1] / calls}))


# ------------------------------------------- sop, srflp, lcs, psp, alp
def sop_brute(dist):
    """The cheapest job order 0 -> ... -> n-1 honouring the -1 precedences
    (dist[i][j] == -1: j before i), or None."""
    n, best = len(dist), None
    for perm in itertools.permutations(range(1, n - 1)):
        seq, done, tot = [0, *perm, n - 1], set(), 0
        for a, b in zip(seq, seq[1:]):
            done.add(a)
            if dist[a][b] == -1 or any(dist[b][j] == -1 and j not in done and j != b
                                       for j in range(n)):
                break
            tot += int(dist[a][b])
        else:
            best = tot if best is None else min(best, tot)
    return best


def srflp_brute2(lengths, flows):
    """Twice the least sum of flow x centre distance over all orders (in
    half units, so exact in integers)."""
    n, best = len(lengths), None
    for perm in itertools.permutations(range(n)):
        x, pos2 = 0, {}
        for d in perm:
            pos2[d] = 2 * x + int(lengths[d])
            x += int(lengths[d])
        tot = sum(int(flows[i][j]) * abs(pos2[i] - pos2[j])
                  for i in range(n) for j in range(i + 1, n))
        best = tot if best is None else min(best, tot)
    return best


def lcs_brute(strings):
    """The longest common subsequence's length, by a DP over position
    tuples."""
    import functools

    @functools.lru_cache(maxsize=None)
    def go(pos):
        best = 0
        for c in set(strings[0][pos[0]:]):
            nxt = []
            for s_, p in zip(strings, pos):
                if c not in s_[p:]:
                    break
                nxt.append(s_.index(c, p) + 1)
            else:
                best = max(best, 1 + go(tuple(nxt)))
        return best

    return go(tuple([0] * len(strings)))


def psp_brute(pb):
    """The least stocking + changeover cost, by a backward DP over (period,
    demand heads, next item)."""
    import functools

    N, H = pb.n_items, pb.horizon
    rem_tbl = pb.demands.cumsum(axis=1)

    @functools.lru_cache(maxsize=None)
    def go(t, heads, nxt):
        if t < 0:
            return 0 if all(h < 0 for h in heads) else None
        rem = sum(int(rem_tbl[i][heads[i]]) for i in range(N) if heads[i] >= 0)
        if rem > t + 1:
            return None
        best = go(t - 1, heads, nxt) if rem < t + 1 else None
        for i in range(N):
            if heads[i] >= t:
                c = (int(pb.changeover[i][nxt]) if nxt >= 0 else 0) \
                    + int(pb.stocking[i]) * (heads[i] - t)
                nh = list(heads)
                nh[i] = int(pb._prev_np[i][heads[i]])
                r = go(t - 1, tuple(nh), i)
                if r is not None and (best is None or c + r < best):
                    best = c + r
        return best

    return go(H - 1, tuple(int(x) for x in pb._prev_np[:, H]), -1)


def alp_brute(pb):
    """The least total delay over every landing order and runway choice."""
    C, R = pb.nb_classes, pb.nb_runways
    nxt = [[0] for _ in range(C)]
    for i in range(pb.nb_variables - 1, -1, -1):
        nxt[pb.classes[i]].append(i)
    best = [None]

    def arrival(info, a, r):
        t, c = info[r]
        tgt = int(pb.target[a])
        if t == 0 and c == -1:
            return tgt
        sep = pb.min_sep_to[pb.classes[a]] if c == -1 else pb.sep[c][pb.classes[a]]
        return max(tgt, t + int(sep))

    def go(rem, info, acc):
        if best[0] is not None and acc >= best[0]:
            return
        if sum(rem) == 0:
            best[0] = acc
            return
        for c in range(C):
            if rem[c]:
                a = nxt[c][rem[c]]
                for r in range(R):
                    t = arrival(info, a, r)
                    if t <= pb.latest[a]:
                        rem2 = list(rem)
                        rem2[c] -= 1
                        info2 = tuple(sorted(info[:r] + info[r + 1:] + ((t, c),)))
                        go(tuple(rem2), info2, acc + t - int(pb.target[a]))

    rem0 = [0] * C
    for c in pb.classes:
        rem0[c] += 1
    go(tuple(rem0), tuple([(0, -1)] * R), 0)
    return best[0]


def small_models(tt):
    """{name: (bundle, dominance or None, cutset, exact optimum)} for the
    five small paths, each a seeded instance at n <= 8 (LCS: three strings
    of 8 letters), its optimum from brute force on the host."""
    from ddo_tpu_torch.models import alp as al, lcs as lc, psp as ps, sop as so, srflp as sr

    out = {}
    pb = so.generate_random(8, SEED, p_prec=0.15)
    best = sop_brute(pb.dist.tolist())
    out["sop"] = (tt.ModelBundle(pb, so.SopRelax(pb), so.SopRanking()), None, True,
                  None if best is None else -best)
    pb = sr.generate_random(7, SEED)
    out["srflp"] = (tt.ModelBundle(pb, sr.SrflpRelax(pb), sr.SrflpRanking()), None, True,
                    srflp_brute2(pb.lengths, pb.flows))
    pb = lc.generate_random(3, 4, 8, SEED)
    out["lcs"] = (tt.ModelBundle(pb, lc.LcsRelax(pb), lc.LcsRanking()), lc.LcsDominance(),
                  False, lcs_brute([list(map(int, s_)) for s_ in pb.strings]))
    pb = ps.generate_random(8, 3, SEED)
    best = psp_brute(pb)
    out["psp"] = (tt.ModelBundle(pb, ps.PspRelax(pb), ps.PspRanking()), None, True,
                  None if best is None else -best)
    pb = al.generate_random(8, 2, 1, SEED)
    best = alp_brute(pb)
    out["alp"] = (tt.ModelBundle(pb, al.AlpRelax(pb), al.AlpRanking()), al.AlpDominance(),
                  False, None if best is None else -best)
    return out


def model_sort_case(name, bundle, dominance, W=SMALL_MODELS_W, L=SMALL_MODELS_BATCH):
    """The K1 sort-1 case of a small model's `maximize` at width W and L
    lanes: (label, L, W x D, keys, payloads)."""
    from ddo_tpu_torch.engine.mdd import sort_operands

    nk, n_ops, _ = sort_operands(bundle, dominance)
    return (f"{name}_sort1", L, W * bundle.problem.domain_size, nk, n_ops - nk)


def phase_small_model(torch, dev, name, spec, W=SMALL_MODELS_W, batch=SMALL_MODELS_BATCH):
    """Phase 11: one of sop, srflp, lcs, psp, alp on the card: a compile of
    3 or 4 lanes rooted at different depths whose every plane equals the
    CPU path's, then `maximize` to gap 0 at the brute-force optimum."""
    import ddo_tpu_torch as tt

    bundle, dominance, lel, opt = spec
    row, _, _ = compile_parity(torch, dev, name, bundle, W, dominance)
    log(json.dumps(row))
    pb = bundle.problem
    dom = None if dominance is None else tt.SimpleDominanceChecker(dominance, pb.nb_variables)
    sol = tt.maximize(pb, bundle.relaxation, bundle.ranking, lel=lel, use_cache=True,
                      width=W, batch=batch, dominance=dom, device=dev)
    row = {"phase": "solve", "model": name, "n": pb.nb_variables, "optimum": opt,
           "objective": sol.objective, "gap": sol.gap, "time_to_optimum_s": sol.duration,
           "width": W, "batch": batch}
    got = sol.objective
    if name == "srflp":  # the layout's cost is root_value - objective
        got = round(2 * (pb.root_value - sol.objective))
        row.update(optimum=None, cost=pb.root_value - sol.objective, brute_force_cost=opt / 2)
    if sol.aborted or sol.gap != 0 or got != opt:
        raise AssertionError(f"maximize({name}): {sol} vs brute force {opt}")
    log(json.dumps(row))


# ------------------------------------------- device loop, native, CLI
def dl_fixture_bundle(tt):
    """The forced-machinery knapsack: 20 items, profit = weight + 0..5,
    capacity half the weight (tests/test_torch_device_loop.py)."""
    import numpy as np

    from ddo_tpu_torch.models import knapsack as kp

    rng = np.random.default_rng(8)
    w = rng.integers(10, 40, 20)
    p = w + rng.integers(0, 6, 20)
    pb = kp.Knapsack.from_numpy(int(w.sum() // 2), p, w)
    return tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking())


def solver_counts(s):
    return {"best": s.best_value(), "ub": s.best_upper_bound(), "explored": s.explored_count,
            "expanded": s.expanded_nodes, "supersteps": s.stats.supersteps,
            "loop_events": dict(getattr(s, "loop_events", {}))}


def phase_device_loop(torch, dev, reset, read, n=DL_N, shapes=DL_SHAPES,
                      slab=DL_SLAB, chunk=DL_CHUNK, cut=DL_CUT):
    """Phase 13: `DeviceLoopSolver` on MISP G(60, 0.2) against the exact
    optimum and against `SequentialSolver` at the same settings, in turns
    (sequential, device loop, device loop, sequential), at each of
    `shapes` (width, lanes): W=256 with 128 lanes, then W=8 with 16 lanes
    (20 supersteps); every chunk under `set_sync_debug_mode("error")`.
    Then the tiny-slab fixture whose slab-full drains, cutset-overflow
    replays and reseeds must give the CPU run's counts.  Returns the
    launches of the device loop's own runs (each zeroed just before it,
    read just after)."""
    import ddo_tpu_torch as tt

    bundle, edges = misp_bundle(tt, n, DL_P, SEED)
    pb = bundle.problem
    weight = [int(w) for w in pb.weight]
    opt = exact_mis(n, edges, weight)
    mine = {"lane_sort": 0, "fused_backward": 0, "layer_tail": 0}
    routes = {}

    def solver(kind, device, bundle, **kw):
        if kind == "sequential":
            return tt.SequentialSolver(bundle, device=device, **kw)
        s = tt.DeviceLoopSolver(bundle, device=device, slab_cap=kw.pop("slab"),
                                chunk_steps=kw.pop("chunk"), cut_cap=kw.pop("cut"), **kw)
        s.sync_debug = "error"
        return s

    def run(kind, device, bundle, **kw):
        s = solver(kind, device, bundle, **kw)
        reset()
        t0 = time.perf_counter()
        done = s.maximize()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, by_route = read()
        if kind == "device_loop" and torch.device(device).type == "cuda":
            for k in mine:
                mine[k] += got[k]
            for kern, by in by_route.items():
                for r, c in by.items():
                    routes.setdefault(kern, {})[r] = routes.get(kern, {}).get(r, 0) + c
        return s, done, wall, got

    for W, batch in shapes:
        walls = {"sequential": [], "device_loop": []}
        for kind in ("sequential", "device_loop", "device_loop", "sequential"):
            loop = dict(slab=slab, chunk=chunk, cut=cut) if kind == "device_loop" else {}
            s, done, wall, got = run(kind, dev, bundle, width_heu=tt.FixedWidth(W),
                                     batch=batch, cache=tt.SimpleCache(), **loop)
            if not done.is_exact or s.best_value() != opt or s.gap() != 0:
                raise AssertionError(f"{kind} on MISP G({n}, {DL_P}): {s.best_value()} vs "
                                     f"exact optimum {opt}")
            vals, pset = s.best_solution()
            check_independent_set(edges, weight,
                                  [int(v) if p_ else 0 for v, p_ in zip(vals, pset)], opt, kind)
            walls[kind].append(wall)
            log(json.dumps({"phase": "device_loop", "solver": kind, "model": "misp", "n": n,
                            "width": W, "batch": batch, **loop, "optimum": opt,
                            "wall_s": wall, "launches": got, **solver_counts(s)}))
        log(json.dumps({"phase": "device_loop_turns", "width": W, "batch": batch,
                        "sequential_s": walls["sequential"],
                        "device_loop_s": walls["device_loop"]}))

    # the fixture: the same solver on the card and on the CPU, the card's
    # extraction route (compact) on both
    fixture = dl_fixture_bundle(tt)
    counts = {}
    for device in ("cpu", dev):
        s = solver("device_loop", device, fixture, width_heu=tt.FixedWidth(2), batch=2,
                    cache=tt.SimpleCache(), cutset_type=tt.FRONTIER, slab=8, chunk=4, cut=4)
        s._compact = True
        reset()
        s.maximize()
        got, by_route = read()
        if torch.device(device).type == "cuda":
            for k in mine:
                mine[k] += got[k]
            for kern, by in by_route.items():
                for r, c in by.items():
                    routes.setdefault(kern, {})[r] = routes.get(kern, {}).get(r, 0) + c
        counts[str(device)] = solver_counts(s)
    cpu, card = counts["cpu"], counts[str(dev)]
    ev = card["loop_events"]
    log(json.dumps({"phase": "device_loop_fixture", "slab_cap": 8, "cut_cap": 4, "batch": 2,
                    "card": card, "cpu": cpu}))
    if card != cpu:
        raise AssertionError(f"device-loop fixture: card {card} vs CPU {cpu}")
    if not (ev["full"] and ev["cutov"] and ev["seeds"] >= 2):
        raise AssertionError(f"device-loop fixture: the machinery did not run: {ev}")
    return mine, routes


def phase_native(torch, dev):
    """Phase 14: `NativeSolver` (the C++ fringe and cache, built with g++
    from the checkout) on the card against exact optima: the drive
    recipe's knapsack (n=200) with the dominance store, MISP G(60, 0.2),
    and the 21-node TSPTW at W=256."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import knapsack as kp, tsptw as ts

    pb = kp.generate_uncorrelated(*NATIVE_KP[:4], seed=NATIVE_KP[4])
    misp, edges = misp_bundle(tt, DL_N, DL_P, SEED)
    tw = ts.generate_random(TSPTW_SMALL_N, SEED)
    cases = [
        ("knapsack", tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()),
         kp.dp_optimum(pb.capacity, pb.profit, pb.weight),
         dict(width_heu=tt.FixedWidth(NATIVE_W), batch=NATIVE_BATCH,
              dominance=tt.SimpleDominanceChecker(kp.KPDominance(), pb.nb_variables))),
        ("misp", misp, exact_mis(DL_N, edges, [int(w) for w in misp.problem.weight]),
         dict(width_heu=tt.FixedWidth(NATIVE_W), batch=NATIVE_BATCH)),
        ("tsptw", tt.ModelBundle(tw, ts.TsptwRelax(tw), ts.TsptwRanking()),
         -tsptw_oracle(tw.dist, tw.twe, tw.twl),
         dict(width_heu=tt.FixedWidth(WIDTH), batch=16,
              dominance=tt.SimpleDominanceChecker(ts.TsptwDominance(), TSPTW_SMALL_N))),
    ]
    for name, bundle, opt, kw in cases:
        s = tt.NativeSolver(bundle, device=dev, **kw)
        t0 = time.perf_counter()
        done = s.maximize()
        wall = time.perf_counter() - t0
        if not done.is_exact or s.best_value() != opt or s.gap() != 0:
            raise AssertionError(f"NativeSolver({name}): {s.best_value()} vs optimum {opt}")
        log(json.dumps({"phase": "native", "model": name, "n": bundle.problem.nb_variables,
                        "optimum": opt, "wall_s": wall, **solver_counts(s)}))


def phase_cli(torch, dev):
    """Phase 15: `python -m ddo_tpu_torch.cli knapsack <file>` in-process on
    the card, on a generated instance written to a temporary file: the
    default flags, `--device-loop` and `--dot`; the Objective line is the
    DP optimum and the dot file a digraph."""
    import contextlib
    import io
    import os
    import tempfile

    from ddo_tpu_torch import cli
    from ddo_tpu_torch.models import knapsack as kp

    pb = kp.generate_uncorrelated(*CLI_KP[:4], seed=CLI_KP[4])
    opt = kp.dp_optimum(pb.capacity, pb.profit, pb.weight)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kp.txt")
        with open(path, "w") as f:
            f.write(f"{pb.nb_variables} {pb.capacity}\n")
            f.writelines(f"{a} {b}\n" for a, b in zip(pb.profit, pb.weight))
        dot = os.path.join(tmp, "root.dot")
        for extra in ([], ["--device-loop"], ["--dot", dot]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["knapsack", path] + extra)
            lines = out.getvalue().splitlines()
            if f"Objective:  {opt}" not in lines or "Aborted:    False" not in lines:
                raise AssertionError(f"cli {extra}: {lines} vs DP optimum {opt}")
            log(json.dumps({"phase": "cli", "flags": extra, "optimum": opt,
                            "lines": [l for l in lines if not l.startswith("Solution")]}))
        with open(dot) as f:
            if not f.read().startswith("digraph {"):
                raise AssertionError("cli --dot: not a digraph")


def phase_wide(torch, dev):
    """Phase 16: models past 128 sort operands on the card, which it once refused:
    `_check_sort_operands` accepts max2sat and max-cut at 135 and 220
    variables, and compiles of 4 lanes rooted at different depths equal
    the CPU path's on every plane: max2sat at 135 variables at W=32
    (sort-1 on K1's "perm" route, 141 operands) and W=256 ("merge"),
    max-cut at 135 (W=32) and max2sat at 220 (W=32, 226 operands)."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.engine.mdd import _check_sort_operands
    from ddo_tpu_torch.models import max2sat as ms, mcp as mc

    def bundle(model, n):
        if model == "max2sat":
            pb, _ = ms.generate_random(n, 3 * n, SEED)
            return tt.ModelBundle(pb, ms.Max2SatRelax(pb), ms.Max2SatRanking())
        pb, _ = mc.generate_random(n, 0.5, SEED)
        return tt.ModelBundle(pb, mc.McpRelax(pb), mc.McpRanking())

    for model in ("max2sat", "mcp"):
        for n in (WIDE_N, WIDE_N2):
            for W in (16, WIDTH):
                _check_sort_operands(bundle(model, n), None, W)
    for model, n, W, route in [("max2sat", WIDE_N, 32, "perm"), ("max2sat", WIDE_N, WIDTH, "merge"),
                               ("mcp", WIDE_N, 32, "perm"), ("max2sat", WIDE_N2, 32, "perm")]:
        before = launch_counts()
        row, _, _ = compile_parity(torch, dev, model, bundle(model, n), W)
        taken = launches_since(before)[1]["lane_sort"]
        if row["sort1"]["route"] != route or not taken[route]:
            raise AssertionError(f"{model} n={n} W={W}: sort-1 is to take the {route} route: "
                                 f"{row}, {taken}")
        log(json.dumps({**row, "sort_operands": n + 6, "lane_sort_routes": taken}))


# ------------------------------------------- the mesh and the tutorial
def solve_row(solver, wall, opt, before):
    """A finished solve's JSON fields, with K1's and K2's launches by route
    since `before` (a `launch_counts()`); raises unless it proved `opt`."""
    if solver.abort_proof is not None or solver.best_value() != opt or solver.gap() != 0:
        raise AssertionError(f"{type(solver.compiler).__name__}: {solver.best_value()} "
                             f"(gap {solver.gap()}) vs optimum {opt}")
    _, by = launches_since(before)
    return {"optimum": opt, "wall_s": wall, "lanes": solver.batch,
            **solver_counts(solver), "lane_sort_routes": by["lane_sort"],
            "fused_backward_routes": by["fused_backward"]}


def launch_counts():
    """The registry's launch counts (`trace.counted`) a path reports: K1's
    and K2's by route, K3's by part, K2's "stream" route by cluster."""
    from ddo_tpu_torch.engine import backward as bwd, layer_tail as lt
    from ddo_tpu_torch.ops import sort as srt
    from ddo_tpu_torch.utils import trace

    return {"lane_sort": {r: trace.counted("lane_sort." + r) for r in srt.ROUTES},
            "fused_backward": {r: trace.counted("fused_backward." + r) for r in bwd.ROUTES},
            "layer_tail": {p: trace.counted("layer_tail." + p) for p in lt.PARTS},
            "stream_clusters": {c: trace.counted(f"fused_backward.stream.{c}")
                                for c in bwd.CLUSTERS_RESIDENT}}


def launches_since(before):
    """(launches of each kernel, and those by route, part or cluster)
    since `before`, a `launch_counts()`."""
    by = {k: {r: m - before[k][r] for r, m in v.items()} for k, v in launch_counts().items()}
    return {k: sum(by[k].values()) for k in ("lane_sort", "fused_backward", "layer_tail")}, by


def phase_mesh(torch, dev, meshes, n=N_ITEMS, W=WIDTH, batch=K_LANES):
    """Phase 18: `MeshSolver` at full width.  Phase 4's knapsack (n=2000,
    W=256, 128 lanes a superstep, cache and dominance) by
    `SequentialSolver` and by `MeshSolver` on each of `meshes` (the card
    alone, and two entries of the card, which splits the lanes), in
    turns: each proves the DP optimum at gap 0 with the sequential
    solver's explored and expanded counts.  Then MISP G(60, 0.2) at W=256
    and 128 lanes on the last mesh (a dynamic order per shard) against
    `exact_mis` and `SequentialSolver`, in turns; then
    `MeshCompiler` on 3 lanes rooted at different depths of a smaller
    knapsack, whose real lanes' planes equal `DDCompiler`'s on the card
    bit for bit, with the same reductions."""
    import ddo_tpu_torch as tt
    from ddo_tpu_torch.models import knapsack as kp

    def in_turns(model, bundle, opt, kw, meshes):
        """`SequentialSolver` and a `MeshSolver` on each mesh, in turns
        (a, b, ..., b, a), one line per solve and one with every wall; all
        must take the same search."""
        makers = [("sequential", None)] + [("mesh", m) for m in meshes]
        rows, walls = [], {}
        for label, mesh in makers + makers[::-1]:
            before = launch_counts()
            solver = (tt.SequentialSolver(bundle, device=dev, **kw()) if mesh is None
                      else tt.MeshSolver(bundle, mesh=mesh, **kw()))
            t0 = time.perf_counter()
            solver.maximize()
            wall = time.perf_counter() - t0
            key = label if mesh is None else f"mesh_{mesh.size}"
            walls.setdefault(f"{key}_s", []).append(wall)
            rows.append({"phase": "mesh", "model": model, "solver": label,
                         "n": bundle.problem.nb_variables,
                         "width": W, **({} if mesh is None else
                                        {"mesh": [str(d) for d in mesh.devices]}),
                         **solve_row(solver, wall, opt, before)})
            log(json.dumps(rows[-1]))
        keys = ("explored", "expanded", "supersteps", "best", "ub")
        if len({tuple(r[k] for k in keys) for r in rows}) != 1:
            raise AssertionError(f"mesh {model}: the solvers' searches differ: "
                                 f"{[{k: r[k] for k in keys} for r in rows]}")
        log(json.dumps({"phase": "mesh_turns", "model": model, **walls}))

    pb = kp.generate_uncorrelated(n, 1000, 1, 100, SEED)
    in_turns("knapsack", tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()),
             kp.dp_optimum(pb.capacity, pb.profit, pb.weight),
             lambda: dict(width_heu=tt.FixedWidth(W), cache=tt.SimpleCache(), batch=batch,
                          dominance=tt.SimpleDominanceChecker(kp.KPDominance(), n)),
             meshes)
    mb, edges = misp_bundle(tt, DL_N, DL_P, SEED)
    in_turns("misp", mb, exact_mis(DL_N, edges, [int(w) for w in mb.problem.weight]),
             lambda: dict(width_heu=tt.FixedWidth(W), cache=tt.SimpleCache(), batch=batch),
             meshes[-1:])

    # 3 lanes rooted at depths 0, 7 and 20 (phase 3's fixture) on the mesh
    # and on the card alone: every plane of the real lanes, bit for bit
    sb, subs = knapsack_depth_lanes(tt)
    dom = kp.KPDominance()
    mc = tt.MeshCompiler(sb, W, tt.FRONTIER, meshes[-1], dominance=dom)
    dc = tt.DDCompiler(sb, W, tt.FRONTIER, dominance=dom, device=dev)
    planes = 0
    for comp in (tt.CompilationType.RESTRICTED, tt.CompilationType.RELAXED):
        got = mc.compile_batch(comp, subs, tt.NEG_INF, [3, 8, W])
        want = dc.compile_batch(comp, subs, tt.NEG_INF, [3, 8, W])
        if len(got) != len(subs) or got.dev["value"].shape[0] != mc.lanes * -(-len(subs)
                                                                            // mc.lanes):
            raise AssertionError(f"mesh compile_batch: {len(got)} views of "
                                 f"{got.dev['value'].shape[0]} lanes")
        for k, v in want.dev.items():
            for a, b in zip(*(list(x.values()) if isinstance(x, dict) else [x]
                              for x in (got.dev[k], v))):
                if not torch.equal(a[:len(subs)], b):
                    raise AssertionError(f"mesh compile_batch ({comp.name}): plane {k} "
                                         f"differs from DDCompiler's")
            planes += 1
        if (got.global_best, got.total_expanded) != (want.global_best, want.total_expanded):
            raise AssertionError(f"mesh compile_batch ({comp.name}): reductions "
                                 f"{got.global_best, got.total_expanded} vs "
                                 f"{want.global_best, want.total_expanded}")
    log(json.dumps({"phase": "mesh_compile_vs_card", "n": sb.problem.nb_variables, "width": W,
                    "mesh": [str(d) for d in meshes[-1].devices],
                    "root_depths": [s.depth for s in subs], "planes": planes,
                    "equal": True}))


def load_tutorial():
    """examples/tutorial_custom_problem_torch.py, loaded by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), TUTORIAL)
    spec = importlib.util.spec_from_file_location("tutorial_custom_problem_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tutorial_bundle(tt, tut):
    pb = tut.IntervalScheduling(*tut.instance())
    return tt.ModelBundle(pb, tut.IntervalRelax(pb), tut.IntervalRanking())


def phase_tutorial(torch, dev, tut):
    """Phase 19: the custom-model tutorial's `main(device)` on the card (its
    printed lines captured): brute force's optimum at gap 0, and the
    Graphviz export of a relaxed root DD."""
    import contextlib
    import io

    start, end, profit = tut.instance()
    opt = tut.brute_force(start.tolist(), end.tolist(), profit.tolist())
    before = launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        solver = tut.main(device=dev)
    wall = time.perf_counter() - t0
    row = solve_row(solver, wall, opt, before)
    log(json.dumps({"phase": "tutorial", "source": TUTORIAL, "n": len(start), **row,
                    "lines": out.getvalue().splitlines()}))


def main(argv):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drives ddo_tpu_torch once on a GPU.")
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout (a parent commit unpacked with git archive) "
                         "whose K1 and K2 phase 2 times in turns beside this one's")
    ap.add_argument("--sweep-k2", action="store_true",
                    help="after the build, time K2's stream route under other values of its "
                         "planner's constants, then stop")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from ddo_tpu_torch.engine import backward as bwd, layer_tail as lt
    from ddo_tpu_torch.ops import sort as srt
    from ddo_tpu_torch.utils import cuda_build, trace

    # ---- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"phase": "device", "torch": torch.__version__,
                    "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)}))
    t0 = time.perf_counter()
    cuda_build.build("lane_sort", "backward", "layer_tail")
    srt._lib()
    bwd._lib()
    lt._lib()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}))
    for name in ("lane_sort", "backward", "layer_tail"):
        log(json.dumps({"phase": "ptxas", "source": f"ddo_tpu_torch/csrc/{name}.cu",
                        "kernels": ptxas_summary(cuda_build.ptxas_report(name))}))
    # K2's planner keeps a lane's cluster count within what the card holds
    # at once: its table may not exceed the card's own count at the most
    # shared memory a "stream" CTA takes
    held = {c: bwd.resident_clusters(c, cuda_build.SMEM_PER_BLOCK, 32 * bwd.STREAM_WARPS)
            for c in bwd.CLUSTERS_RESIDENT}
    log(json.dumps({"phase": "clusters", "smem": cuda_build.SMEM_PER_BLOCK, "card": held,
                    "planner": bwd.CLUSTERS_RESIDENT}))
    if any(held[c] < n for c, n in bwd.CLUSTERS_RESIDENT.items()):
        raise AssertionError(f"the card holds fewer clusters than K2's planner assumes: {held}")
    if opts.sweep_k2:
        sweep_k2(torch, dev)
        return 0

    # ---- 2. kernels against their plain versions
    import ddo_tpu_torch as tt

    from ddo_tpu_torch.models import knapsack as kp

    models = small_models(tt)
    extra = [model_sort_case(name, spec[0], spec[1]) for name, spec in models.items()]
    # the compile sorts of the device loop's MISP, NativeSolver's and the
    # CLI's knapsacks (both with the dominance columns)
    extra.append(model_sort_case("dl_misp60", misp_bundle(tt, DL_N, DL_P, SEED)[0], None,
                                 W=WIDTH, L=K_LANES))
    for name, args, W, L in (("native_kp", NATIVE_KP, NATIVE_W, NATIVE_BATCH),
                             ("cli_kp", CLI_KP, CLI_W, CLI_BATCH)):
        pb = kp.generate_uncorrelated(*args[:4], seed=args[4])
        extra.append(model_sort_case(name, tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()),
                                     kp.KPDominance(), W=W, L=L))
    # the mesh's MISP shards of 64 lanes, and the tutorial's sort-1
    extra.append(model_sort_case("mesh_misp60", misp_bundle(tt, DL_N, DL_P, SEED)[0], None,
                                 W=WIDTH, L=K_LANES // 2))
    tut = load_tutorial()
    extra.append(model_sort_case("tutorial", tutorial_bundle(tt, tut), None, W=TUTORIAL_W,
                                 L=TUTORIAL_LANES))
    parent = tree_kernels(opts.parent) if opts.parent else None
    rows = phase_kernels(torch, dev, extra, parent)
    rows.update(phase_k3(torch, dev, models, tut))

    # ---- 3-19. each path with its own launch counts: zeroed just before
    # it, read just after, and both kernels must have launched in it
    launches = {}

    base = [launch_counts()]

    def reset():
        base[0] = launch_counts()

    def read():
        return launches_since(base[0])

    graph_use = {}

    def graph_counts():
        return {k: trace.counted(name) for k, name in (
            ("layers", "layers"), ("graph_layers", "graph_layers"),
            ("k3_layers", "layer_tail.dominance"), ("captures", "graph_captures"),
            ("replays", "graph_replays"))}

    def counted(path, drive):
        """Drive one path between a reset and a read of the counts; a
        drive that returns (launches, routes) counts its own runs only.
        Beside them: the path's layer-loop iterations, those replayed from
        CUDA graphs, those whose tail ran through K3 (its last part's
        runs), and the graphs captured and replayed (three a layer)."""
        reset()
        before = graph_counts()
        t0 = time.perf_counter()
        own = drive()
        launches[path], routes = own if own else read()
        graph_use[path] = {k: v - before[k] for k, v in graph_counts().items()}
        log(json.dumps({"phase": "launches", "path": path, **launches[path],
                        "routes": routes, "graphs": graph_use[path],
                        "seconds": time.perf_counter() - t0}))
        if not all(launches[path].values()):
            raise AssertionError(f"a kernel of the {path} path never launched: "
                                 f"{launches[path]}")

    def knapsack():
        pb, opt = phase_compile(torch, dev)
        phase_solve(torch, dev, pb, opt)

    def misp():
        phase_misp_compile(torch, dev)
        phase_small_solve(torch, dev, "misp")

    def tsptw():
        phase_tsptw_compile(torch, dev, rows)
        phase_tsptw_solve(torch, dev)

    counted("knapsack", knapsack)
    phase_cpu_parity(torch, dev)  # outside every count
    counted("misp", misp)
    counted("max2sat", lambda: phase_small_solve(torch, dev, "max2sat"))
    counted("mcp", lambda: phase_small_solve(torch, dev, "mcp"))
    counted("tsptw", tsptw)
    counted("tsptw_search", lambda: phase_tsptw_search(torch, dev))
    for name, spec in models.items():
        counted(name, lambda: phase_small_model(torch, dev, name, spec))
    counted("device_loop", lambda: phase_device_loop(torch, dev, reset, read))
    counted("native", lambda: phase_native(torch, dev))
    counted("cli", lambda: phase_cli(torch, dev))
    counted("wide", lambda: phase_wide(torch, dev))
    counted("mesh", lambda: phase_mesh(torch, dev, (tt.make_mesh(), tt.make_mesh([dev, dev]))))
    counted("tutorial", lambda: phase_tutorial(torch, dev, tut))
    # the main paths replay their layers from CUDA graphs, each replayed
    # layer's third graph running K3 (counted from what its capture
    # recorded); mcp's and sop's layer bodies wait on the host, so they run
    # eagerly
    for path in ("knapsack", "tsptw"):
        use = graph_use[path]
        if not use["graph_layers"] or use["k3_layers"] < use["graph_layers"]:
            raise AssertionError(f"the {path} path replayed no layer, or some without K3: "
                                 f"{use}")
    for path in ("mcp", "sop"):
        if graph_use[path]["graph_layers"]:
            raise AssertionError(f"the {path} path replayed layers: {graph_use[path]}")

    # the N20 class at W=256 (lanes of 5,376 candidates: sort-1 on the
    # merge route) and LCS with 10 strings over 20 letters, both in no
    # count: the card's planes equal the CPU's through the merge route
    from ddo_tpu_torch.models import lcs as lc, tsptw as ts

    pb = ts.generate_random(TSPTW_SMALL_N, SEED)
    row, _, _ = compile_parity(torch, dev, "tsptw",
                               tt.ModelBundle(pb, ts.TsptwRelax(pb), ts.TsptwRanking()),
                               WIDTH, ts.TsptwDominance())
    pb = lc.generate_random(10, 20, 60, SEED)
    row2, _, _ = compile_parity(torch, dev, "lcs",
                                tt.ModelBundle(pb, lc.LcsRelax(pb), lc.LcsRanking()),
                                WIDTH, lc.LcsDominance())
    for r in (row, row2):
        if r["sort1"]["route"] != "merge":
            raise AssertionError(f"{r['model']} fixture: sort-1 is to take the merge route")
        log(json.dumps(r))

    kernels = []
    paths = [("knapsack", "sort1", "main"), ("misp", "misp_sort1", "misp"),
             ("max2sat", "small_sort1", "small"), ("mcp", "small_sort1", "small"),
             ("tsptw", "tsptw_sort1", "tsptw"), ("tsptw_search", "tsptw_sort1", "tsptw_1lane")]
    paths += [(name, f"{name}_sort1", "small_models") for name in models]
    paths += [("device_loop", "slab_pop", "dl_misp60"), ("native", "native_kp_sort1", "native_kp"),
              ("cli", "cli_kp_sort1", "cli_kp"), ("wide", "max2sat135_w256", "wide_max2sat"),
              ("mesh", "mesh_misp60_sort1", "mesh_misp60"),
              ("tutorial", "tutorial_sort1", "tutorial")]
    for path, sort_case_, backward_case_ in paths:
        for name, src, replaces, main_case in [
            ("lane_sort", "ddo_tpu_torch/csrc/lane_sort.cu",
             "ddo_tpu/ops/sort_pallas.py:285", sort_case_),
            ("fused_backward", "ddo_tpu_torch/csrc/backward.cu",
             "ddo_tpu/engine/backward.py:346", backward_case_),
            ("layer_tail", "ddo_tpu_torch/csrc/layer_tail.cu",
             "none: plain ops of ddo_tpu/engine/mdd.py:637-895", K3_OF_PATH[path]),
        ]:
            main = rows[(name, main_case)]
            kernels.append({"name": name, "route": "cuda", "source": src, "path": path,
                            "case": main_case, "kernel_route": main.get("route", "parts"),
                            "replaces": replaces, "launches": launches[path][name],
                            "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                                               if k[0] == name),
                            "ms": main["ms"], "plain_ms": main["plain_ms"],
                            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                            "share_of_bound": main["share_of_bound"],
                            # no single PyTorch call sorts lanes lexicographically
                            # on several keys with payloads, runs the sweep or the
                            # layer's tail
                            "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
