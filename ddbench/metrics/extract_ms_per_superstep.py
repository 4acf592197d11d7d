"""The extraction's wall per superstep: the port's own
`SolverStats.extract_s` (the compiled batches read on the host: the
compact rows, planes and scalars a superstep reads, and the waits for
them) over its `supersteps`, summed over the window's solves before its
traced end.  A solve's stats are the entry of `trace.SOLVES` that began
inside it; a port without them reads nothing.  None on the CPU, where
nothing is waited for."""

UNIT = "ms"
LAYER = "compile and extraction"
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
    n = sum(st.supersteps for st in stats)
    return 1000.0 * sum(st.extract_s for st in stats) / n if n else None
