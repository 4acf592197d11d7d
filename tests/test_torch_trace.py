"""The port's own timing and counting (ddo_tpu_torch/utils/trace.py): the
five phases of `SolverStats` tile a solve on every superstep route, the
profiler's spans lie on the solve's `time.time_ns` bracket and add up
to its phases, no span is entered without a profiler, the host-sync
count of fixed instances, the registry of counts (a capture's tally, a
replay, `utils/cuda_build.py`'s `launch`, and no import of the engine
from `utils/`), the four benchmark metrics that read the stats, and, on
a card, that every wait on the device is a counted one."""

import os
import subprocess
import sys
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ddo_tpu_torch as tt
from ddbench import cell as cells
from ddo_tpu_torch.models import knapsack as kp
from ddo_tpu_torch.models import tsptw as ts
from ddo_tpu_torch.search.solver import SolverStats
from ddo_tpu_torch.utils import cuda_build, trace

PHASES = ("pop_s", "snapshot_s", "compile_s", "extract_s", "absorb_s")
#: each span and the SolverStats field it times
SPAN_FIELDS = {"ddo.search.pop": "pop_s", "ddo.search.snapshot": "snapshot_s",
               "ddo.compile.restricted": "compile_s", "ddo.compile.relaxed": "compile_s",
               "ddo.extract": "extract_s", "ddo.search.absorb": "absorb_s"}
READERS = ("layer_issue_ms", "host_syncs_per_superstep", "extract_ms_per_superstep",
           "search_upkeep_pct")


def knapsack():
    """20 correlated items (profit = weight + 0..5, capacity half the
    weight), which keep many nodes open."""
    rng = np.random.default_rng(8)
    w = rng.integers(10, 40, 20)
    pb = kp.Knapsack.from_numpy(int(w.sum() // 2), w + rng.integers(0, 6, 20), w)
    return tt.ModelBundle(pb, kp.KPRelax(pb), kp.KPRanking()), kp.KPDominance()


def tsptw():
    pb = ts.generate_random(7, seed=5, window=100.0)
    return tt.ModelBundle(pb, ts.TsptwRelax(pb), ts.TsptwRanking()), ts.TsptwDominance()


MODELS = {"knapsack": knapsack, "tsptw": tsptw}
#: every superstep route: the solver and its settings; the two-pass
#: route runs under a budget with compiles chunked below n
ROUTES = {
    "sequential-fused": (tt.SequentialSolver, dict(batch=4)),
    "sequential-two-pass": (tt.SequentialSolver, dict(batch=4, compile_chunk=3)),
    "parallel-fused": (tt.ParallelSolver, dict(batch=16)),
    "parallel-two-pass": (tt.ParallelSolver, dict(batch=16, compile_chunk=3)),
    "device-loop": (tt.DeviceLoopSolver, dict(batch=4, slab_cap=64, chunk_steps=4,
                                              cut_cap=32)),
    # a cut cap of one row: most supersteps replay through the host path
    "device-loop-replay": (tt.DeviceLoopSolver, dict(batch=2, slab_cap=8, chunk_steps=4,
                                                     cut_cap=1)),
    "native-fused": (tt.NativeSolver, dict(batch=4)),
    "native-two-pass": (tt.NativeSolver, dict(batch=4)),
}


def make(model, route, width=4):
    bundle, dom = MODELS[model]()
    cls, kw = ROUTES[route]
    n = bundle.problem.nb_variables
    kw = dict(kw, width_heu=tt.FixedWidth(width), device="cpu",
              dominance=tt.SimpleDominanceChecker(dom, n))
    if route.endswith("two-pass"):
        kw["cutoff"] = tt.TimeBudget(600.0)
    if cls is not tt.NativeSolver:
        return cls(bundle, cache=tt.SimpleCache(), **kw)
    solver = cls(bundle, **kw)
    if "cutoff" in kw:
        solver.compile_chunk = 3  # below n: the two-pass route
    return solver


def phase_sum(st):
    return sum(getattr(st, f) for f in PHASES)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("route", list(ROUTES))
def test_phases_add_up_to_the_solve(model, route):
    solver = make(model, route)
    before = len(trace.SOLVES)
    completion = solver.maximize()
    st = solver.stats
    assert completion.is_exact
    assert abs(phase_sum(st) - st.total_s) <= max(0.02 * st.total_s, 1e-3)
    assert min(getattr(st, f) for f in PHASES) >= 0 and st.compile_s > 0
    # the older fields cut the same wall, and no part of it twice
    assert st.restricted_s + st.relaxed_s + st.host_s <= st.total_s + 1e-6
    assert st.layers >= st.supersteps >= 1 and st.host_syncs > 0
    assert st.start_ns < st.end_ns
    assert len(trace.SOLVES) == min(before + 1, trace.SOLVES.maxlen)
    assert trace.SOLVES[-1].total_s == st.total_s and trace.SOLVES[-1] is not st
    if route == "device-loop-replay":
        assert solver.loop_events["cutov"] >= 1
    if route.endswith("two-pass"):
        assert st.relaxed_s > 0


@pytest.mark.parametrize("route", ["sequential-fused", "sequential-two-pass", "device-loop"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_spans_lie_on_the_solve_and_add_up_to_its_phases(model, route):
    with profile(activities=[ProfilerActivity.CPU]):
        # the first solve builds what later ones reuse, and the first span
        # of a process resolves the profiler's operations
        make(model, route).maximize()
    if route == "device-loop":
        # a chunk's host time (compile_s) holds its pops, walks and pushes
        # besides its compiles
        fields = set(SPAN_FIELDS.values()) - {"compile_s"}
    else:
        fields = set(SPAN_FIELDS.values())
    # A field's clock is read just inside its span's ends, so a span is
    # longer by the profiler's own work at its ends, a few microseconds,
    # unless the scheduler takes the test's process off the CPU there: a
    # solve is run again, up to three times in all, until no field is off.
    for _ in range(3):
        solver = make(model, route)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            solver.maximize()
        st = solver.stats
        spans = [e for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("ddo.")]
        names = {e.name() for e in spans}
        assert {"ddo.search.pop", "ddo.compile.restricted", "ddo.compile.relaxed",
                "ddo.layer.expand", "ddo.layer.squash", "ddo.finalize"} <= names
        assert not {n for n in names if n.startswith("ddbench.")}
        for e in spans:
            assert st.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= st.end_ns
        off = {}
        for field in fields:
            spans_s = sum(e.duration_ns() for e in spans
                          if SPAN_FIELDS.get(e.name()) == field) / 1e9
            if abs(spans_s - getattr(st, field)) > max(0.05 * getattr(st, field), 1e-3):
                off[field] = (spans_s, getattr(st, field))
        if not off:
            break
    assert not off


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    entered = []
    enter = torch.autograd.profiler.record_function.__enter__
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: entered.append(self.name) or enter(self))
    for route in ("sequential-fused", "sequential-two-pass", "device-loop"):
        solver = make("knapsack", route)
        solver.maximize()
        st = solver.stats
        assert st.compile_s > 0 and st.layers > 0 and st.host_syncs > 0
        assert abs(phase_sum(st) - st.total_s) <= max(0.02 * st.total_s, 1e-3)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        make("knapsack", "sequential-fused").maximize()
    assert "ddo.layer.dedup" in entered  # the patch sees the spans


@pytest.mark.parametrize("model, compact, syncs", [
    ("knapsack", False, 175), ("knapsack", True, 69),
    ("tsptw", False, 334), ("tsptw", True, 162)])
def test_host_syncs_of_a_fixed_instance(model, compact, syncs):
    """The plane route reads each plane it needs with a `.cpu()`; the
    compact one selects rows on the device (`torch.nonzero`) and brings
    them over with one synchronize per extraction."""
    solver = make(model, "sequential-fused")
    solver._compact = compact
    before = trace.counted("host_syncs")
    solver.maximize()
    assert solver.stats.host_syncs == trace.counted("host_syncs") - before == syncs


def test_layers_count_every_compiles_loop(monkeypatch):
    from ddo_tpu_torch.engine import mdd

    calls = []
    compile_lanes = mdd.compile_lanes

    def counted(spec, *args, **kw):
        calls.append(spec.bundle.problem.nb_variables - kw.get("start", 0))
        return compile_lanes(spec, *args, **kw)

    monkeypatch.setattr(mdd, "compile_lanes", counted)
    solver = make("knapsack", "sequential-two-pass")
    solver.maximize()
    assert len(calls) > 2 and solver.stats.layers == sum(calls)


@pytest.mark.parametrize("capturing", [False, True])
def test_a_count_while_capturing_goes_to_the_tally(capturing):
    """Inside a capture's tally a count goes to the tally, not to the
    total; outside one it goes to the total (and to no tally)."""
    before = trace.counted("layer_tail"), trace.counted("layer_tail.edges")
    if capturing:
        with trace.tally() as tally:
            trace.count("layer_tail.edges")
            trace.count("layer_tail.remap", 2)
        assert tally == {"layer_tail.edges": 1, "layer_tail.remap": 2}
        assert (trace.counted("layer_tail"), trace.counted("layer_tail.edges")) == before
    else:
        trace.count("layer_tail.edges")
        trace.count("layer_tail.remap", 2)
        assert trace.counted("layer_tail") == before[0] + 3
        assert trace.counted("layer_tail.edges") == before[1] + 1
    assert trace._tally is None


def test_a_replay_adds_its_tally_and_k3_layers_follow_it(monkeypatch):
    """A replay adds its tally name by name, and a solve's
    `SolverStats.k3_layers` is the runs of K3's last part across it."""
    monkeypatch.setattr(trace, "SOLVES", trace.SOLVES.__class__(maxlen=4))
    names = ("layer_tail.remap", "layer_tail.dominance", "graph_layers", "graph_replays",
             "lane_sort.regs")
    before = {name: trace.counted(name) for name in names}
    with trace.tally() as tally:
        trace.count("layer_tail.remap", 3)
        trace.count("layer_tail.dominance")
    tally.update(graph_replays=3, graph_layers=1)
    stats = SolverStats()
    clock = trace.Phases(stats)
    clock.lap("pop")
    for _ in range(2):
        trace.replayed(tally)
    clock.stop()
    assert {name: trace.counted(name) - n for name, n in before.items()} == {
        "layer_tail.remap": 6, "layer_tail.dominance": 2, "graph_layers": 2,
        "graph_replays": 6, "lane_sort.regs": 0}
    assert (stats.k3_layers, stats.graph_layers, stats.layers) == (2, 2, 0)
    assert trace.SOLVES[-1].k3_layers == 2


@pytest.mark.parametrize("status", [0, 2])
def test_launch_passes_the_stream_checks_and_counts(status, monkeypatch):
    """`cuda_build.launch` calls the entry point with the current stream
    last, in the device's context; a non-zero status raises and counts
    nothing, any other counts one launch of its name."""
    entered = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 77})())
    calls = []
    before = trace.counted("fused_backward.stream.4"), trace.counted("fused_backward")
    launch = lambda: cuda_build.launch("fused_backward.stream.4",
                                       lambda *a: calls.append(a) or status, "cuda:1", 5, 6)
    if status:
        with pytest.raises(RuntimeError, match="fused_backward.stream.4 failed with CUDA "
                                               "status 2"):
            launch()
    else:
        launch()
    assert calls == [(5, 6, 77)] and entered == ["cuda:1"]
    added = 0 if status else 1
    assert trace.counted("fused_backward.stream.4") == before[0] + added
    assert trace.counted("fused_backward") == before[1] + added


def test_utils_import_nothing_of_the_engine():
    """`utils/trace.py` and `utils/cuda_build.py`, imported in a fresh
    interpreter without the package's `__init__` (which imports
    everything), load no module of `engine/`, `ops/` or `search/`."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(trace.__file__)))
    code = (
        "import sys, types\n"
        "pkg = types.ModuleType('ddo_tpu_torch')\n"
        f"pkg.__path__ = [{pkg!r}]\n"
        "sys.modules['ddo_tpu_torch'] = pkg\n"
        "import ddo_tpu_torch.utils.trace, ddo_tpu_torch.utils.cuda_build\n"
        "print(sorted(m for m in sys.modules if m.startswith('ddo_tpu_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = eval(out)
    assert "ddo_tpu_torch.utils.cuda_build" in loaded
    assert not [m for m in loaded if m.split(".")[1] in ("engine", "ops", "search")]


def _reader(name):
    return cells.load_file(os.path.join(cells.HERE, "metrics", name + ".py"))


def _stats(start, **kw):
    return SolverStats(start=start, **kw)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_the_ring_on_a_card_only(name, monkeypatch):
    ring = trace.SOLVES.__class__(maxlen=trace.SOLVES.maxlen)
    monkeypatch.setattr(trace, "SOLVES", ring)
    a = _stats(10.5, total_s=2.0, supersteps=1, layers=100, compile_s=1.5, extract_s=0.01,
               pop_s=0.1, snapshot_s=0.05, absorb_s=0.34, host_syncs=20)
    b = _stats(20.5, total_s=4.0, supersteps=3, layers=300, compile_s=2.5, extract_s=0.05,
               pop_s=0.2, snapshot_s=0.15, absorb_s=1.1, host_syncs=40)
    profiled = _stats(30.5, total_s=9.0, supersteps=9, layers=900, compile_s=9.0,
                      extract_s=9.0, pop_s=9.0, snapshot_s=9.0, absorb_s=9.0, host_syncs=999)
    ring.extend([_stats(0.5, total_s=1.0, supersteps=1, layers=1, compile_s=1.0), a, b,
                 profiled])
    solves = [dict(start=10.0, end=12.6, profiled=False), dict(start=20.0, end=24.6, profiled=False),
              dict(start=30.0, end=40.0, profiled="device")]
    reader = _reader(name)
    assert reader.read({"platform": "cpu", "solves": solves, "trace": None}) is None
    value = reader.read({"platform": "gpu", "solves": solves, "trace": None})
    expected = {"layer_issue_ms": 1000 * 4.0 / 400, "host_syncs_per_superstep": 60 / 4,
                "extract_ms_per_superstep": 1000 * 0.06 / 4,
                "search_upkeep_pct": 100 * (0.1 + 0.05 + 0.34 + 0.2 + 0.15 + 1.1) / 6.0}[name]
    assert value == pytest.approx(expected)
    # no ring entry began inside any record: nothing to read
    ring.clear()
    assert reader.read({"platform": "gpu", "solves": solves, "trace": None}) is None


def test_solve_in_takes_the_newest_start_inside_the_bracket(monkeypatch):
    ring = trace.SOLVES.__class__(maxlen=3)
    monkeypatch.setattr(trace, "SOLVES", ring)
    ring.extend(_stats(t) for t in (1.0, 2.0, 3.0, 4.0))
    assert [st.start for st in ring] == [2.0, 3.0, 4.0]
    assert trace.solve_in(1.5, 3.5).start == 3.0
    assert trace.solve_in(0.0, 1.5) is None


def _cell_solver(name):
    """A solver of the cell's main path, as the benchmark builds it."""
    cell = cells.Cell(name)
    inst = cell.instance(2**31 + 77, cells.MEASURED, 0)
    problem, relax, ranking, dominance = cell.family.port_model(inst)
    s = cell.settings
    return tt.SequentialSolver(
        tt.ModelBundle(problem, relax, ranking), width_heu=tt.FixedWidth(int(s["width"])),
        cutset_type=tt.CutsetType[s["cutset"]], cache=getattr(tt, s["cache"])(),
        fringe=getattr(tt, s["fringe"])(),
        dominance=tt.SimpleDominanceChecker(dominance, problem.nb_variables),
        batch=int(s["batch"]), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kp-uncorr-n100", "tsptw-n20w40"])
def test_every_wait_on_the_card_is_counted(name):
    """One solve of each cell's path under `set_sync_debug_mode("warn")`:
    every synchronizing call warns, and each warning's stack passes
    through `trace.wait`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _cell_solver(name).maximize()  # builds the kernels
    solver = _cell_solver(name)
    torch.cuda.synchronize()
    stacks, solving = [], [False]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **k: solving[0] and stacks.append(
            traceback.extract_stack())
        torch.cuda.set_sync_debug_mode("warn")  # which may warn itself
        try:
            solving[0] = True
            before = trace.counted("host_syncs")
            solver.maximize()
            counted = trace.counted("host_syncs") - before
        finally:
            solving[0] = False
            torch.cuda.set_sync_debug_mode(0)
    waits = [s for s in stacks if any(f.name == "wait" and f.filename == trace.__file__
                                      for f in s)]
    uncounted = [s[-3:] for s in stacks if s not in waits]
    assert stacks and not uncounted, uncounted[:3]
    assert counted == solver.stats.host_syncs >= len(waits) > 0
