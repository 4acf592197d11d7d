"""The host's time to queue one iteration of the compile's layer loop: the
port's own `SolverStats.compile_s` (the compiles' wall on the host, the
sweep after each loop included) over its `layers` (n - start per
compile), summed over the window's solves before its traced end.  A
solve's stats are the entry of `trace.SOLVES` that began inside it; a
port without them reads nothing.  None on the CPU, where a torch
operation runs as it is called."""

UNIT = "ms"
LAYER = "compile layer loop"
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
    n = sum(st.layers for st in stats)
    return 1000.0 * sum(st.compile_s for st in stats) / n if n else None
