"""Host syncs per superstep: the port's own count of the places where it
waits on the device (`SolverStats.host_syncs`: stream synchronizes,
reads of a device tensor on the host, `torch.nonzero`, copies from host
arrays) over its `supersteps`, summed over the window's solves before
its traced end.  A solve's stats are the entry of `trace.SOLVES` that
began inside it; a port without them reads nothing.  None on the CPU,
where a sync waits for nothing."""

UNIT = "syncs"
LAYER = "compile and extraction"
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
    stats = [st for st in stats if st is not None]
    n = sum(st.supersteps for st in stats)
    return sum(st.host_syncs for st in stats) / n if n else None
