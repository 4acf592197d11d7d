"""Command-line solver for every model of the port: counterpart of
`ddo_tpu/cli.py`, with its flags and its output lines.

The reference ships one clap binary per problem (e.g.
examples/knapsack/main.rs:314-358); here a single entry point covers all
of them with the same flags and the same output format:

    python -m ddo_tpu_torch.cli <problem> <instance> [--width W] [--batch K]
        [--duration SECS] [--cutset lel|frontier] [--no-cache] [--cpu]
        [--device-loop] [--dot out.dot]

Problems: knapsack, misp, max2sat, mcp, golomb (instance = n),
talentsched, lcs, tsptw, sop, srflp, alp, psp.  It solves on the card
unless given `--cpu`, which runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import time



def _dominance_for(problem, pb):
    """The per-problem dominance relation the reference's main.rs wires in
    (knapsack, tsptw, alp, lcs); None elsewhere."""
    if problem == "knapsack":
        from ddo_tpu_torch.models.knapsack import KPDominance
        return KPDominance()
    if problem == "tsptw":
        from ddo_tpu_torch.models.tsptw import TsptwDominance
        return TsptwDominance()
    if problem == "alp":
        from ddo_tpu_torch.models.alp import AlpDominance
        return AlpDominance()
    if problem == "lcs":
        from ddo_tpu_torch.models.lcs import LcsDominance
        return LcsDominance()
    return None


def build(problem: str, instance: str):
    """Returns (problem, bundle, width_heu_default, objective_transform)."""
    from ddo_tpu_torch import FixedWidth, ModelBundle, NbUnassignedWidth

    ident = lambda pb, v: v
    if problem == "knapsack":
        from ddo_tpu_torch.models.knapsack import KPRanking, KPRelax, read_instance

        pb = read_instance(instance)
        return pb, ModelBundle(pb, KPRelax(pb), KPRanking()), FixedWidth(2), ident
    if problem == "misp":
        from ddo_tpu_torch.models.misp import MispRanking, MispRelax, read_instance

        pb = read_instance(instance)
        return pb, ModelBundle(pb, MispRelax(pb), MispRanking(pb)), \
            NbUnassignedWidth(pb.nb_variables), ident
    if problem == "max2sat":
        from ddo_tpu_torch.models.max2sat import Max2SatRanking, Max2SatRelax, read_instance

        pb = read_instance(instance)
        return pb, ModelBundle(pb, Max2SatRelax(pb), Max2SatRanking()), \
            NbUnassignedWidth(pb.nb_variables), ident
    if problem == "mcp":
        from ddo_tpu_torch.models.mcp import McpRanking, McpRelax, read_instance

        pb = read_instance(instance)
        return pb, ModelBundle(pb, McpRelax(pb), McpRanking()), \
            NbUnassignedWidth(pb.nb_variables), ident
    if problem == "golomb":
        from ddo_tpu_torch.models.golomb import Golomb, GolombRanking, GolombRelax

        pb = Golomb(int(instance))
        return pb, ModelBundle(pb, GolombRelax(pb), GolombRanking()), \
            FixedWidth(10), (lambda pb, v: -v)
    if problem == "talentsched":
        from ddo_tpu_torch.models.talentsched import (
            TalentSchedRanking, TalentSchedRelax, read_instance,
        )

        pb = read_instance(instance)
        return pb, ModelBundle(pb, TalentSchedRelax(pb), TalentSchedRanking()), \
            FixedWidth(100), (lambda pb, v: -v)
    if problem == "lcs":
        from ddo_tpu_torch.models.lcs import LcsRanking, LcsRelax, read_instance

        pb = read_instance(instance)
        return pb, ModelBundle(pb, LcsRelax(pb), LcsRanking()), \
            NbUnassignedWidth(pb.nb_variables), ident
    if problem == "tsptw":
        from ddo_tpu_torch.models.tsptw import (
            TsptwRanking, TsptwRelax, TsptwWidth, read_instance,
        )

        pb = read_instance(instance)
        return pb, ModelBundle(pb, TsptwRelax(pb), TsptwRanking()), \
            TsptwWidth(pb.nb_variables, 1), (lambda pb, v: -v / 10000.0)
    if problem == "sop":
        from ddo_tpu_torch.models.sop import SopRanking, SopRelax, SopWidth, read_instance

        pb = read_instance(instance)
        return pb, ModelBundle(pb, SopRelax(pb), SopRanking()), \
            SopWidth(pb.nb_variables, 1), (lambda pb, v: -v)
    if problem == "srflp":
        from ddo_tpu_torch.models.srflp import (
            SrflpRanking, SrflpRelax, SrflpWidth, read_instance,
        )

        pb = read_instance(instance)
        return pb, ModelBundle(pb, SrflpRelax(pb), SrflpRanking()), \
            SrflpWidth(pb.nb_variables, 1), (lambda pb, v: -v + pb.root_value)
    if problem == "alp":
        from ddo_tpu_torch.models.alp import AlpRanking, AlpRelax, read_instance

        pb = read_instance(instance)
        return pb, ModelBundle(pb, AlpRelax(pb), AlpRanking()), \
            NbUnassignedWidth(pb.nb_variables), (lambda pb, v: -v)
    if problem == "psp":
        from ddo_tpu_torch.models.psp import PspRanking, PspRelax, read_instance

        pb, _ = read_instance(instance)
        return pb, ModelBundle(pb, PspRelax(pb), PspRanking()), \
            NbUnassignedWidth(pb.nb_variables), (lambda pb, v: -v)
    raise SystemExit(f"unknown problem {problem!r}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ddo_tpu_torch")
    parser.add_argument("problem", help="problem name (knapsack, misp, ...)")
    parser.add_argument("instance", help="instance file (or n for golomb)")
    parser.add_argument("-w", "--width", type=int, default=None)
    parser.add_argument("-b", "--batch", type=int, default=4,
                        help="frontier superstep batch (lanes)")
    parser.add_argument("-d", "--duration", type=float, default=None,
                        help="time budget in seconds")
    parser.add_argument("--cutset", choices=["lel", "frontier"], default="lel")
    parser.add_argument("--no-cache", action="store_true")
    parser.add_argument("--no-dominance", action="store_true",
                        help="disable the problem's dominance relation")
    parser.add_argument("--no-filtering", action="store_true",
                        help="disable in-compilation cache/dominance filtering")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    parser.add_argument("--device-loop", action="store_true",
                        help="device-resident search loop (k supersteps "
                             "per dispatch; best for deep/narrow searches)")
    parser.add_argument("--chunk-steps", type=int, default=16,
                        help="supersteps per dispatch with --device-loop")
    parser.add_argument("--slab-cap", type=int, default=8192,
                        help="device fringe capacity with --device-loop")
    parser.add_argument("--dot", default=None,
                        help="write a relaxed-DD graphviz dot of the root")
    args = parser.parse_args(argv)

    import ddo_tpu_torch as tt
    from ddo_tpu_torch import (
        FixedWidth, NoCutoff, SimpleCache, SimpleDominanceChecker, TimeBudget,
    )

    pb, bundle, width_heu, transform = build(args.problem, args.instance)
    if args.width is not None:
        width_heu = FixedWidth(args.width)
    dom = None if args.no_dominance else _dominance_for(args.problem, pb)

    kw = dict(
        width_heu=width_heu,
        batch=args.batch,
        cache=tt.EmptyCache() if args.no_cache else SimpleCache(),
        cutset_type=(
            tt.LAST_EXACT_LAYER if args.cutset == "lel" else tt.FRONTIER
        ),
        cutoff=TimeBudget(args.duration) if args.duration else NoCutoff(),
        dominance=(
            SimpleDominanceChecker(dom, pb.nb_variables) if dom else None
        ),
        in_compile_filtering=not args.no_filtering,
        device="cpu" if args.cpu else "cuda",
    )
    if args.device_loop:
        solver = tt.DeviceLoopSolver(
            bundle, slab_cap=args.slab_cap, cut_cap=args.slab_cap // 2,
            chunk_steps=args.chunk_steps, **kw,
        )
    else:
        solver = tt.SequentialSolver(bundle, **kw)

    start = time.time()
    completion = solver.maximize()
    duration = time.time() - start

    best = completion.best_value
    objective = transform(pb, best) if best is not None else -1
    sol = solver.best_solution()
    values = [int(v) for v, s in zip(*sol)] if sol is not None else []

    print(f"Duration:   {duration:.3f} seconds")
    print(f"Objective:  {objective}")
    print(f"Upper Bnd:  {solver.best_upper_bound()}")
    print(f"Lower Bnd:  {solver.best_lower_bound()}")
    print(f"Gap:        {solver.gap():.3f}")
    print(f"Aborted:    {not completion.is_exact}")
    print(f"Explored:   {solver.explored()}")
    print(f"Expanded:   {solver.expanded_nodes}")
    print(f"Stats:      {solver.stats.summary(solver.explored(), solver.expanded_nodes)}")
    print(f"Solution:   {values}")

    if args.dot:
        from ddo_tpu_torch.core.types import CompilationType, root_subproblem
        from ddo_tpu_torch.engine.viz import as_graphviz

        dd = solver.compiler.compile(
            CompilationType.RELAXED, root_subproblem(pb), tt.NEG_INF,
            width_heu.max_width(root_subproblem(pb)),
        )
        with open(args.dot, "w") as f:
            f.write(as_graphviz(dd))
        print(f"Dot:        {args.dot}")


if __name__ == "__main__":
    main()
