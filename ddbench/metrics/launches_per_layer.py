"""Kernels launched per iteration of the compile's layer loop in the
device's traced stretch: the runtime's launch calls that began inside a
`compile_lanes` call, over the iterations the benchmark's wrapper of
`compile_lanes` counted (n - start per call).  A call's few launches
after its loop (the backward sweep) count with it; the search loop's and
the extraction's do not."""

UNIT = "launches"
LAYER = "compile layer loop"
MOVES = "solve_p95_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx["trace"]
    if (ctx["platform"] != "gpu" or tr is None or not tr["layer_iters"]
            or not tr["compile_launch_calls"]):
        return None
    return tr["compile_launch_calls"] / tr["layer_iters"]
