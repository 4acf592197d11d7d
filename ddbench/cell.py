"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

Everything that belongs to one configuration, traffic mix, family or
per-layer metric is data or a file of its own, found by name:

  * `BENCHMARK.json` (the checkout's root): the cell's configuration,
    traffic, chips and metrics;
  * `ddbench/configs/<config>.json`: the instance family, its sizes and
    the solver settings of the port's main path;
  * `ddbench/workloads/<cell>.json`: the traffic mix, which names its
    configuration and traffic and adds the generator's parameters;
  * `ddbench/families/<family>.py` (`generate`, `port_model`) and
    `<family>_ref.py` (`optimum`, `replay`, `control`);
  * `ddbench/metrics/<metric>.py`: `UNIT`, `LAYER`, `MOVES`, `SOURCE` and
    `read(ctx)`, which returns the metric or None where it finds nothing.

The window is a closed loop of one client: instance i of the stream is
drawn from (seed, i) and handed to the port as arrays, and the next solve
starts when the last one ends, while fewer than `seconds` have passed
since the first one started; the last one runs to its end.  A traced run
profiles the window's last `profile_s` seconds, and one solve after them
(`_traced_solves`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np

from ddbench import devtrace, judge, stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "ddbench")
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ddo_tpu")
#: streams of instances drawn from one seed
MEASURED, WARMUP = 0, 1


def load_file(path: str):
    """The module in the file `path`, by path (metric names may hold dots)."""
    name = "ddbench_" + os.path.relpath(path, HERE).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of `BENCHMARK.json` with its files loaded.  `overrides`
    replaces configuration sizes and settings (the CPU tests run a cell's
    path at a size a test can hold)."""

    def __init__(self, name: str, bench: dict | None = None, overrides: dict | None = None):
        bench = bench if bench is not None else read_json(os.path.join(ROOT, "BENCHMARK.json"))
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name, self.chips = name, int(entry["chips"])
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.config = read_json(os.path.join(ROOT, conf["file"]))
        self.traffic = read_json(os.path.join(HERE, "workloads", name + ".json"))
        for key in ("config", "traffic"):
            if self.traffic[key] != entry[key]:
                raise ValueError(f"ddbench/workloads/{name}.json names {key} "
                                 f"{self.traffic[key]!r}, BENCHMARK.json {entry[key]!r}")
        self.params = {**self.config["instance"], **self.traffic["params"]}
        self.settings = dict(self.config["settings"])
        for key, value in (overrides or {}).items():
            (self.settings if key in self.settings else self.params)[key] = value
        family = self.config["family"]
        self.family = load_file(os.path.join(HERE, "families", family + ".py"))
        self.ref = load_file(os.path.join(HERE, "families", family + "_ref.py"))
        self.profile_s = float(self.traffic["profile_s"])
        in_cell = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if in_cell(m)]
        self.per_layer = []
        for m in filter(in_cell, bench["per_layer"]):
            reader = load_file(os.path.join(HERE, "metrics", m["name"] + ".py"))
            for key in ("unit", "layer", "moves", "source"):
                if getattr(reader, key.upper()) != m[key]:
                    raise ValueError(f"ddbench/metrics/{m['name']}.py: {key} "
                                     f"{getattr(reader, key.upper())!r}, BENCHMARK.json {m[key]!r}")
            self.per_layer.append((m, reader))

    def instance(self, seed: int, stream: int, i: int) -> dict:
        """Instance i of `stream` drawn from `seed` (any integer)."""
        seq = np.random.SeedSequence(entropy=int(seed) % (1 << 64), spawn_key=(stream, i))
        return self.family.generate(self.params, np.random.default_rng(seq))


def solve(cell: Cell, inst: dict, budget_s: float, device: str) -> dict:
    """One solve on the port's main path, timed from the arrays to the
    proved optimum: `SequentialSolver.maximize` built as `maximize` builds
    it (api.py), with the configuration's width, lanes and dominance.  The
    budget is polled between supersteps; a chunk of n layers leaves the
    compile whole, as without a budget."""
    import torch
    import ddo_tpu_torch as tt

    s = cell.settings
    start = time.perf_counter()
    problem, relax, ranking, dominance = cell.family.port_model(inst)
    n = problem.nb_variables
    solver = tt.SequentialSolver(
        tt.ModelBundle(problem, relax, ranking),
        width_heu=tt.FixedWidth(int(s["width"])),
        cutset_type=tt.CutsetType[s["cutset"]],
        cache=getattr(tt, s["cache"])(),
        fringe=getattr(tt, s["fringe"])(),
        dominance=tt.SimpleDominanceChecker(dominance, n) if s["dominance"] else None,
        cutoff=tt.TimeBudget(budget_s),
        compile_chunk=n,
        batch=int(s["batch"]),
        device=device,
    )
    completion = solver.maximize()
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    end = time.perf_counter()
    best = solver.best_solution()
    st = solver.stats
    return {
        "start": start, "end": end, "wall_s": end - start,
        "exact": bool(completion.is_exact), "objective": solver.best_value(),
        "lower": solver.best_lower_bound(), "upper": solver.best_upper_bound(),
        "vals": None if best is None else np.asarray(best[0]),
        "pset": None if best is None else np.asarray(best[1]),
        "supersteps": st.supersteps, "host_s": st.host_s, "total_s": st.total_s,
        "compile_s": st.restricted_s + st.relaxed_s, "expanded": solver.expanded_nodes,
        "profiled": False,
    }


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float | None = None):
    """(result dict, lines for standard error) of one run; `t0` is when the
    process began (the start of `setup_s`)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    on_gpu = torch.device(device).type == "cuda"
    if on_gpu:
        torch.cuda.init()
    t_init = time.perf_counter()
    warm = solve(cell, cell.instance(seed, WARMUP, 0), seconds, device)

    records, instances, traced = [], [], None
    begin = time.perf_counter()
    unprofiled_s = seconds - cell.profile_s if trace else seconds
    while not records or time.perf_counter() - begin < unprofiled_s:
        inst = cell.instance(seed, MEASURED, len(records))
        instances.append(inst)
        records.append(solve(cell, inst, seconds, device))
    if trace:
        traced = _traced_solves(cell, seed, seconds, device, records, instances)
    first = records[0]["start"]
    last = records[-1]["end"]
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    trace_out = None
    if traced:
        trace_out = devtrace.reduce(traced[0].events(), traced[2])
        trace_out["idle_gaps"] = devtrace.label_idle(traced[1].events())
        trace_out.update(_profiler_cost(records))

    verdict = judge.judge(records, instances, cell.ref)
    walls = [r["wall_s"] for r in records]
    ok = judge.correct(verdict["counts"])
    done = len(records) - verdict["failed"]
    lines = [f"{cell.name} seed {seed}: {len(records)} solves in a window of "
             f"{last - first:.6f} s, {done} proved correct; solve_p95_s over "
             f"{len(walls)} solves; set-up {first - t0:.6f} s, of which "
             f"{t_init - t0:.6f} s before the warm-up solve and "
             f"{warm['wall_s']:.6f} s in it"]
    metrics = {}
    if trace:
        ctx = {"platform": "gpu" if on_gpu else "cpu", "solves": records, "trace": trace_out}
        for m, reader in cell.per_layer:
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"solve_p95_s": stats.percentile(walls, 95), "setup_s": first - t0}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": cell.chips if on_gpu else 0, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": len(records), "failed": verdict["failed"],
              "metrics": metrics, "device": dev}
    if trace_out is not None:
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_s"]
        result["breakdown"] = {"device_ops": trace_out["device_ops"],
                               "idle_gaps": trace_out["idle_gaps"]}
        lines.append("trace: " + json.dumps({k: v for k, v in trace_out.items()
                                             if k not in ("device_ops", "idle_gaps")}))
    lines.append("solve walls (s, in order): " + " ".join(f"{w:.3f}" for w in walls))
    if verdict["wrong"]:
        lines.append(f"solves judged wrong: {verdict['wrong']}")
    result["checks"] = {name: {"value": verdict["counts"][name], "limit": limit}
                        for name, limit in judge.LIMITS.items()}
    return result, lines + judge.lines(verdict["counts"], len(records))


def _traced_solves(cell, seed, seconds, device, records, instances):
    """The traced end of the window, whole solves, at least one in each
    part: the device's stretch, `profile_s` seconds from the profiler's
    start, under the
    profiler's CUDA activity alone (host activity on a CPU run, which has
    no device) and the benchmark's wrappers; then one solve under host and
    CUDA activity, which labels the device's idle gaps.  It comes last
    because the profiler's CUDA tracing slows the launches of the solves
    after it.  Returns both profilers' kineto results and the tracer,
    which `devtrace` reads once the window has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_gpu = torch.device(device).type == "cuda"
    host = [ProfilerActivity.CPU]
    cuda = [ProfilerActivity.CUDA] if on_gpu else []

    def one(stage):
        inst = cell.instance(seed, MEASURED, len(records))
        instances.append(inst)
        with record_function(devtrace.SPAN_PREFIX + "solve"):
            records.append(solve(cell, inst, seconds, device))
        records[-1]["profiled"] = stage

    with devtrace.Tracer() as tracer:
        with profile(activities=cuda or host) as prof:
            tracer.start()
            traced = time.perf_counter()  # the profiler takes a while to start
            one("device")
            while time.perf_counter() - traced < cell.profile_s:
                one("device")
            tracer.stop()
        with profile(activities=host + cuda) as labels:
            with record_function(devtrace.WINDOW_SPAN):
                one("labels")
    return prof.profiler.kineto_results, labels.profiler.kineto_results, tracer


def _profiler_cost(records) -> dict:
    """The mean wall of a solve without the profiler, in the device's
    stretch and in the labelling trace: what the profiler adds to a
    solve."""
    mean = lambda stage: float(np.mean([r["wall_s"] for r in records
                                        if r["profiled"] == stage] or [np.nan]))
    return {"solve_s_unprofiled": mean(False), "solve_s_device_trace": mean("device"),
            "solve_s_labels_trace": mean("labels")}


def forbidden_modules():
    """The modules of `FORBIDDEN` in this process, compared by whole
    top-level name (`ddo_tpu_torch` is not `ddo_tpu`)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))
