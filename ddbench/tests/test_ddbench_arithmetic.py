"""The metric arithmetic: percentiles, the device's busy union, the
idle gaps' labels and the kernels' bounds."""

import statistics

import pytest

from ddbench import devtrace, roofline, stats


def test_p95_over_all_solves():
    walls = [1.0] * 19 + [3.0]
    assert stats.percentile(walls, 95) == pytest.approx(1.1)  # rank 18.05 of 0..19
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([0.5], 95) == 0.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_busy_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 25), (21, 22), (30, 30)]
    assert stats.union_length(iv) == 20
    assert stats.union_length([]) == 0
    assert stats.gaps(iv, 0, 40) == [(15, 20), (25, 30), (30, 40)]
    assert stats.gaps(iv, -5, 12) == [(-5, 0)]
    assert stats.gaps([], 0, 3) == [(0, 3)]


def test_spread_uses_statistics_quartiles():
    values = [1.0, 1.1, 0.9, 1.05, 0.95, 1.2]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / q2)


def test_bounds_reproduce_the_kernel_table():
    # PERF.md's kernel table: row 1, sort-1 [128, 512] of 4 keys and 4
    # payloads, 1.252 us; row 4, K2 [128, 2000, 256, 2], 0.939 ms
    assert roofline.sort_bound(128, 512, 4, 8) == pytest.approx(1.252e-6, rel=1e-3)
    assert roofline.backward_bound(128, 2000, 256, 2) == pytest.approx(0.939e-3, rel=1e-3)
    assert roofline.bound(3.35e12, 0) == (1.0, "bytes")


class Ev:
    """A stand-in for a profiler event of torch releases without
    `activity_type`."""

    def __init__(self, name, start, dur, device="CPU", annotation=False, thread=1):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._ann, self._t = device, annotation, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType." + self._dev

    def is_user_annotation(self):
        return self._ann

    def start_thread_id(self):
        return self._t


def test_reduce_a_synthetic_trace():
    events = [
        Ev("cudaLaunchKernel", 90, 5, thread=99),  # before the compile
        Ev("cudaLaunchKernel", 160, 10, thread=99),
        Ev("cudaLaunchKernel", 410, 10, thread=99),
        Ev("cudaLaunchKernelExC", 950, 10, thread=99),  # after it
        Ev("cudaLaunchKernel", 1500, 10, thread=99),  # after the stretch
        Ev("void lane_sort_net_kernel<4>(SortArgs<32>)", 200, 100, device="CUDA"),
        Ev("void backward_tma_kernel(BwdArgs)", 250, 150, device="CUDA"),
        Ev("Memcpy DtoH (Device -> Pinned)", 450, 50, device="CUDA"),
        Ev("outside", 2000, 10, device="CUDA"),
    ]
    tracer = devtrace.Tracer()
    tracer.window, tracer.compile_spans = (0, 1000), [(100, 500), (600, 900)]
    tracer.layer_iters, tracer.k1_calls, tracer.k1_bound_s = 2, 1, 1e-8
    out = devtrace.reduce(events, tracer)
    assert out["window_s"] == 1e-6
    assert out["busy_s"] == 250e-9  # [200, 400) and [450, 500)
    assert out["kernels"] == 2 and out["launch_calls"] == 4
    assert out["compile_launch_calls"] == 2 and out["compile_s"] == 700e-9
    assert out["k1_device_s"] == 100e-9 and out["k2_device_s"] == 150e-9
    assert out["device_ops"][0] == ["void backward_tma_kernel(BwdArgs)", 150e-9]


def test_inside_sorted_spans():
    spans = [(100, 500), (600, 900)]
    assert [devtrace._inside(t, spans) for t in (99, 100, 500, 550, 600, 900, 901)] == \
        [False, True, True, False, True, True, False]
    assert not devtrace._inside(5, [])


def test_label_the_idle_gaps_of_a_synthetic_trace():
    events = [
        Ev(devtrace.WINDOW_SPAN, 0, 1000, annotation=True),
        Ev("ddbench.compile_lanes", 100, 800, annotation=True),
        Ev("aten::where", 150, 100),
        Ev("cudaLaunchKernel", 160, 10, thread=99),
        Ev("aten::copy_", 400, 200),
        Ev("cudaLaunchKernel", 410, 10, thread=99),
        Ev("void lane_sort_net_kernel<4>(SortArgs<32>)", 200, 100, device="CUDA"),
        Ev("void backward_tma_kernel(BwdArgs)", 250, 150, device="CUDA"),
        Ev("Memcpy DtoH (Device -> Pinned)", 450, 50, device="CUDA"),
        Ev("ddbench.gpu", 0, 1000, device="CUDA", annotation=True),
        Ev("aten::add", 100, 10, thread=7),  # another thread's
    ]
    # idle [0, 200) under the window alone, [400, 450) and [500, 1000)
    # while aten::copy_ (from 400 to 600) was the innermost operation
    assert dict(devtrace.label_idle(events)) == pytest.approx(
        {"ddbench.window / -": 200e-9, "ddbench.compile_lanes / aten::copy_": 550e-9})


def test_label_gaps_by_innermost_span_and_operation():
    host = [(0, 1000, "ddbench.window"), (100, 900, "ddbench.compile_lanes"),
            (150, 250, "aten::where"), (160, 170, "cudaLaunchKernel"),
            (400, 600, "aten::copy_")]
    gaps = [(0, 100), (120, 150), (165, 200), (400, 450), (700, 800), (950, 1000)]
    out = devtrace._label_gaps(gaps, host)
    assert out == {"ddbench.window / -": 100 + 50,
                   "ddbench.compile_lanes / -": 30 + 100,
                   "ddbench.compile_lanes / cudaLaunchKernel": 35,
                   "ddbench.compile_lanes / aten::copy_": 50}
