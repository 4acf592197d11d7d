"""K1's share of its roofline in the device's traced stretch: the sum of every
K1 call's least time (`roofline.sort_bound` of its shape) over the sum of
K1's kernels' device time (`lane_sort_net_kernel`, `merge_*_kernel`)."""

UNIT = "%"
LAYER = "kernel K1"
MOVES = "solve_p95_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx["trace"]
    if ctx["platform"] != "gpu" or tr is None or not tr["k1_calls"] or tr["k1_device_s"] <= 0:
        return None
    return 100.0 * tr["k1_bound_s"] / tr["k1_device_s"]
