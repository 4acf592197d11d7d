"""The share of the compile's layer-loop iterations whose tail ran
through the port's kernel K3 (its engine/layer_tail.py, eagerly or
replayed): its own `SolverStats.k3_layers` over its `layers` (n - start
per compile), summed over the window's solves before its traced end, in
percent.  A solve's stats are the entry of `trace.SOLVES` that began
inside it; a port whose stats have no `k3_layers` reads nothing.  None on
the CPU, where the tail runs its plain version."""

UNIT = "%"
LAYER = "compile layer loop"
MOVES = "solve_p95_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx["platform"] != "gpu":
        return None
    try:
        from ddo_tpu_torch.utils import trace
    except ImportError:
        return None
    stats = [trace.solve_in(s["start"], s["end"]) for s in ctx["solves"] if not s["profiled"]]
    stats = [st for st in stats if st is not None and hasattr(st, "k3_layers")]
    n = sum(st.layers for st in stats)
    return 100.0 * sum(st.k3_layers for st in stats) / n if n else None
