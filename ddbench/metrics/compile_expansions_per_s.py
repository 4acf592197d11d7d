"""Node expansions per second of the compile and its extraction: the
solver's `expanded_nodes` over `SolverStats.restricted_s + relaxed_s`
(which time the K-lane compiles together with the compact extraction),
summed over the window's solves before its traced end."""

UNIT = "nodes/s"
LAYER = "compile and extraction"
MOVES = "solve_p95_s"
SOURCE = "program_span"


def read(ctx):
    solves = [s for s in ctx["solves"] if not s["profiled"]]
    seconds = sum(s["compile_s"] for s in solves)
    return sum(s["expanded"] for s in solves) / seconds if seconds > 0 else None
