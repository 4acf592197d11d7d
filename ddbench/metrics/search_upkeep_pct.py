"""The search loop's upkeep as a share of a solve: the port's own
`SolverStats.pop_s + snapshot_s + absorb_s` (set-up, pops and their
probes, eviction, filter-table snapshots, incumbent, cache and dominance
rows, cutset rows, their paths and fringe pushes) over `total_s`, summed
over the window's solves before its traced end.  A solve's stats are the
entry of `trace.SOLVES` that began inside it; a port without them reads
nothing.  None on the CPU, where queueing a compile is computing it."""

UNIT = "%"
LAYER = "search loop"
MOVES = "solve_p95_s"
SOURCE = "program_span"


def read(ctx):
    if ctx["platform"] != "gpu":
        return None
    try:
        from ddo_tpu_torch.utils import trace
    except ImportError:
        return None
    stats = [trace.solve_in(s["start"], s["end"]) for s in ctx["solves"] if not s["profiled"]]
    stats = [st for st in stats if st is not None]
    total = sum(st.total_s for st in stats)
    upkeep = sum(st.pop_s + st.snapshot_s + st.absorb_s for st in stats)
    return 100.0 * upkeep / total if total > 0 else None
