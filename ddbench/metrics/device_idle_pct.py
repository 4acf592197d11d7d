"""The device's idle share of its traced stretch: one minus the union of
its kernel and copy intervals over the stretch's wall, both from the
same run.  The profiler slows the host's issue of the solves it traces
(the trace line on standard error gives a solve's mean wall with and
without it), so this reads the idle share of a traced solve, above an
untraced one's."""

UNIT = "%"
LAYER = "device"
MOVES = "solve_p95_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx["trace"]
    if ctx["platform"] != "gpu" or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
