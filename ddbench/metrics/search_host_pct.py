"""The search loop's share of a solve on the host: `SolverStats.host_s`
(extraction's upkeep, cache, dominance, fringe) over `total_s`, summed
over the window's solves before its traced end."""

UNIT = "%"
LAYER = "search loop"
MOVES = "solve_p95_s"
SOURCE = "program_span"


def read(ctx):
    solves = [s for s in ctx["solves"] if not s["profiled"]]
    total = sum(s["total_s"] for s in solves)
    return 100.0 * sum(s["host_s"] for s in solves) / total if total > 0 else None
