"""K2's share of its roofline in the device's traced stretch: the sum of every
K2 call's least time (`roofline.backward_bound` of its shape) over the sum
of K2's kernels' device time (`backward_*_kernel`)."""

UNIT = "%"
LAYER = "kernel K2"
MOVES = "solve_p95_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx["trace"]
    if ctx["platform"] != "gpu" or tr is None or not tr["k2_calls"] or tr["k2_device_s"] <= 0:
        return None
    return 100.0 * tr["k2_bound_s"] / tr["k2_device_s"]
