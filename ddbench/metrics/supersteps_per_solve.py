"""Supersteps (`SolverStats.supersteps`: K-lane compiles of popped
subproblems) per solve, over all the window's solves."""

UNIT = "supersteps"
LAYER = "search loop"
MOVES = "solve_p95_s"
SOURCE = "program_counter"


def read(ctx):
    solves = ctx["solves"]
    return sum(s["supersteps"] for s in solves) / len(solves) if solves else None
