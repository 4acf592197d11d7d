"""The traced end of a `--trace 1` run: spans and counters the benchmark
records around the port's layer boundaries, and the reduction of the
profiler's traces to per-layer numbers.

A traced run profiles twice, after its unprofiled solves (see
`cell._traced_solves`):

  * the device's stretch, `profile_s` seconds of whole solves under the
    profiler's CUDA activity alone (kernels, copies and the runtime's
    calls; no host operations, shapes or stacks: the least overhead the
    profiler has).  Every device number reads it (`reduce`).  Its wall,
    and the compile's spans inside it, are taken on the host's clock
    (`time.time_ns`, the clock of the profiler's timestamps) by `Tracer`;
  * one more solve under host and CUDA activity, whose trace only labels
    the device's idle gaps by what the host was doing (`label_idle`).

While `Tracer` is active it wraps three of the port's entries, by
attribute, and restores them on exit:

  * `engine.mdd.compile_lanes` (one K-lane compile: the layer loop, then
    the backward sweep): its span on the host's clock, the profiler span
    `ddbench.compile_lanes` and the count of layer-loop iterations,
    n - start per call;
  * `ops.sort.multi_sort_cuda` (K1): each call's `roofline.sort_bound` from
    its (L, C, num_keys, operands);
  * `engine.backward.fused_backward_cuda` (K2): each call's
    `roofline.backward_bound` from its (K, n, W, D).

Both reductions read the profiler's raw events (kineto's, without
building torch's aggregated tables, which takes minutes for a few hundred
thousand launches).
"""

from __future__ import annotations

import collections
import time

from ddbench import roofline, stats

WINDOW_SPAN = "ddbench.window"
SPAN_PREFIX = "ddbench."
#: the port's kernels by name (csrc/lane_sort.cu, csrc/backward.cu)
K1_KERNELS = ("lane_sort_net_kernel", "merge_tile_kernel", "merge_pass_kernel",
              "merge_gather_kernel")
K2_KERNELS = ("backward_direct_kernel", "backward_tma_kernel", "backward_stream_kernel")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
NAME_CHARS = 160
TOP = 10


class Tracer:
    """Counters of the device's stretch, and the wrappers that fill them
    (a context manager).  `start()` and `stop()` mark the stretch's wall;
    only the counts between them are kept."""

    def __init__(self):
        self.window = None  # (start, end) in ns on the host's clock
        self.compile_spans = []  # (start, end) of each compile_lanes call
        self.layer_iters = 0
        self.k1_calls = 0
        self.k1_bound_s = 0.0
        self.k2_calls = 0
        self.k2_bound_s = 0.0
        self._saved = []
        self._on = False

    def start(self):
        self._on = True
        self.window = (time.time_ns(), None)

    def stop(self):
        self._on = False
        self.window = (self.window[0], time.time_ns())

    def __enter__(self):
        import torch
        from ddo_tpu_torch.engine import backward, mdd
        from ddo_tpu_torch.ops import sort

        compile_lanes = mdd.compile_lanes
        multi_sort_cuda = sort.multi_sort_cuda
        fused_backward_cuda = backward.fused_backward_cuda

        def traced_compile(spec, *args, **kw):
            with torch.profiler.record_function(SPAN_PREFIX + "compile_lanes"):
                t0 = time.time_ns()
                out = compile_lanes(spec, *args, **kw)
            if self._on:
                self.compile_spans.append((t0, time.time_ns()))
                self.layer_iters += spec.bundle.problem.nb_variables - kw.get("start", 0)
            return out

        def traced_sort(operands, num_keys, *args, **kw):
            if self._on:
                L, C = operands[0].shape
                self.k1_calls += 1
                self.k1_bound_s += roofline.sort_bound(L, C, num_keys, len(operands))
            return multi_sort_cuda(operands, num_keys, *args, **kw)

        def traced_backward(E_child, *args, **kw):
            if self._on:
                K, n, W = args[2].shape  # S_val
                self.k2_calls += 1
                self.k2_bound_s += roofline.backward_bound(K, n, W, E_child.shape[2] // W)
            return fused_backward_cuda(E_child, *args, **kw)

        for mod, name, fn in ((mdd, "compile_lanes", traced_compile),
                              (sort, "multi_sort_cuda", traced_sort),
                              (backward, "fused_backward_cuda", traced_backward)):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()
        return False


def _activity(ev) -> str:
    """Kineto's activity type of an event ("kernel", "gpu_memcpy",
    "gpu_memset", "cpu_op", "user_annotation", "cuda_runtime", ...), from
    the event's device and name where the torch release does not expose
    it."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type()).rsplit(".", 1)[-1].lower()
    name = ev.name()
    annotation = bool(getattr(ev, "is_user_annotation", lambda: False)())
    if str(ev.device_type()).endswith("CUDA"):
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    if name.startswith("cuda") or name.startswith("cu") and name[2:3].isupper():
        return "cuda_runtime"
    return "cpu_op"


def reduce(events, tracer: Tracer) -> dict:
    """The device's stretch in numbers, from its profiler's raw events and
    the tracer: its wall (`tracer.window`), the union of the device's
    kernel and copy intervals inside it, the kernels launched in all and
    while a compile ran (the runtime's launch calls that began inside a
    `compile_lanes` span), the port's kernels' device time and the device
    operations that took most time."""
    w0, w1 = tracer.window
    spans = sorted(tracer.compile_spans)
    device, launches, in_compile = [], 0, 0
    by_name = collections.Counter()
    kernels, k1_ns, k2_ns = 0, 0, 0
    for e in events:
        act = _activity(e)
        if act in DEVICE_ACTIVITIES:
            s = max(e.start_ns(), w0)
            t = min(e.start_ns() + e.duration_ns(), w1)
            if t <= s:
                continue
            device.append((s, t))
            name = e.name()
            by_name[name[:NAME_CHARS]] += t - s
            if act == "kernel":
                kernels += 1
                if any(k in name for k in K1_KERNELS):
                    k1_ns += e.duration_ns()
                elif any(k in name for k in K2_KERNELS):
                    k2_ns += e.duration_ns()
        elif act in ("cuda_runtime", "cuda_driver") and e.name() in LAUNCH_CALLS:
            t = e.start_ns()
            if w0 <= t <= w1:
                launches += 1
                in_compile += _inside(t, spans)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": stats.union_length(device) / 1e9,
        "kernels": kernels,
        "launch_calls": launches,
        "compile_launch_calls": in_compile,
        "compile_s": sum(t - s for s, t in spans) / 1e9,
        "layer_iters": tracer.layer_iters,
        "k1_calls": tracer.k1_calls, "k1_bound_s": tracer.k1_bound_s, "k1_device_s": k1_ns / 1e9,
        "k2_calls": tracer.k2_calls, "k2_bound_s": tracer.k2_bound_s, "k2_device_s": k2_ns / 1e9,
        "device_ops": [[name, ns / 1e9] for name, ns in by_name.most_common(TOP)],
    }


def _inside(t, spans) -> bool:
    """Whether t lies in one of the sorted, disjoint (start, end) spans."""
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][1] < t:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(spans) and spans[lo][0] <= t


def label_idle(events) -> list:
    """The idle time of the labelling trace's `ddbench.window` span by what
    the host was doing: the device's gaps, labelled by the innermost
    `ddbench.` span and host operation open when each began; the largest
    `TOP` as [label, seconds]."""
    window = [e for e in events if e.name() == WINDOW_SPAN and _activity(e) == "user_annotation"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} {WINDOW_SPAN} spans, not one")
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    thread = window[0].start_thread_id()
    device, host = [], []
    for e in events:
        act = _activity(e)
        if act in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif act in HOST_ACTIVITIES:
            # operations and spans of the thread that ran the window; the
            # runtime's calls, which CUPTI may file under another thread
            # id, of every thread (the port issues from one)
            if act in ("cuda_runtime", "cuda_driver") or e.start_thread_id() == thread:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    idle = _label_gaps(stats.gaps(device, w0, w1), host)
    return [[label, ns / 1e9] for label, ns in idle.most_common(TOP)]


def _label_gaps(gap_list, host) -> collections.Counter:
    """Idle nanoseconds by "<innermost ddbench span> / <innermost host
    operation>" open at the start of each gap ("-" where there is none).
    Host events of one thread nest, so a stack swept in start order holds
    exactly the events open at a time."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, k = collections.Counter(), [], 0
    for g0, g1 in gap_list:
        while k < len(host) and host[k][0] <= g0:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        open_now = [h for h in stack if h[1] > g0]
        span = next((h[2] for h in reversed(open_now) if h[2].startswith(SPAN_PREFIX)), "-")
        top = open_now[-1][2] if open_now and not open_now[-1][2].startswith(SPAN_PREFIX) else "-"
        out[f"{span} / {top}"] += g1 - g0
    return out
