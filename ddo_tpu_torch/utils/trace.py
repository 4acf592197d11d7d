"""The port's timing and counting of itself: spans on the profiler's
timeline, the phase clock of a solve, the registry of counts and the
stats of recent solves.

Spans.  A span names a stretch of the host's work, "ddo.<layer>.<phase>".
While a `torch.profiler` session records, it is a `record_function`, so
it lies on kineto's timeline and clock with the operations it launches;
otherwise it costs nothing.  Whether a session records is read once per
compile (`laps`) and once per superstep (`Phases.lap` of "pop"), never
per span: entering a `record_function` costs ~13 us on a CPU even with
no profiler, which a compile's ~1,400 layer spans would add to it.  No
name starts with "ddbench.": a benchmark's own spans start so.

Counts.  Every count of the port is a name in one registry: `count`
adds to it, `counted(name)` reads it with every name under it
("lane_sort" sums "lane_sort.regs", ".perm" and ".merge").  The names:
"host_syncs", the waits on the device, each a call through `wait`
(synchronizes, host reads of a CUDA tensor, `torch.nonzero`, copies from
host arrays; counted on the CPU too, so a CPU run counts a card run's
waits); "layers", the layer-loop iterations of every compile,
"graph_layers" those replayed from CUDA graphs, "graph_captures" and
"graph_replays" three a layer; and the launches of each hand-written
kernel (`cuda_build.launch`): "lane_sort.<route>" (K1),
"fused_backward.<route>" (K2, "fused_backward.stream.<c>" in clusters of
c CTAs) and "layer_tail.<part>" (K3).  A solve's share is the difference
across it (`Phases`).  A wait cannot be recorded into a CUDA graph: while
the current stream captures, `wait` raises `CaptureRefused`, and that
layer body runs eagerly (engine/mdd.py).  A kernel recorded into a graph
runs on each replay: its capture opens a `tally`, which takes the counts
in place of the totals, and each replay adds the tally (`replayed`).
The code that captures opens it, so no count asks the driver whether the
stream captures (K1, launched from the host twice a layer, stays one
dictionary add).

Recent solves.  `SOLVES` keeps the `SolverStats` of the last 1,024
finished solves of the process, newest last (`solve_in` finds one by its
start).  It, the totals and the open tally are the only state of this
module.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import time

import torch

#: the SolverStats of the most recent finished solves, newest last
SOLVES = collections.deque(maxlen=1024)
#: every count of the process since import, by name
_totals = collections.Counter()
#: the tally of the open capture (`tally`), or None
_tally = None
#: the SolverStats field `Phases` fills from each count
STATS = {"layers": "layers", "graph_layers": "graph_layers",
         "k3_layers": "layer_tail.dominance", "host_syncs": "host_syncs"}

#: each phase of a solve: its profiler span (None: the compile, whose
#: `compile_lanes` calls open their own)
PHASES = {"pop": "ddo.search.pop", "snapshot": "ddo.search.snapshot", "compile": None,
          "extract": "ddo.extract", "absorb": "ddo.search.absorb"}


def profiling() -> bool:
    """Whether a `torch.profiler` session records now (one attribute read)."""
    return torch.autograd.profiler._is_profiler_enabled


def count(name: str, n: int = 1):
    """Add n to count `name`: to the open capture's tally while one is
    open (`tally`), else to its total."""
    (_totals if _tally is None else _tally)[name] += n


def counted(name: str) -> int:
    """The total of count `name` and of every name under it (`name.*`)."""
    under = name + "."
    return _totals[name] + sum(n for k, n in _totals.items() if k.startswith(under))


@contextlib.contextmanager
def tally():
    """A context whose counts go to a new tally (a Counter, yielded)
    instead of the totals: the launches a CUDA graph's capture records,
    which each replay of the graph adds (`replayed`)."""
    global _tally
    outer, _tally = _tally, collections.Counter()
    try:
        yield _tally
    finally:
        _tally = outer


def replayed(counts):
    """Count one replay of what a capture's `tally` holds, name by name."""
    for name, n in counts.items():
        count(name, n)


class CaptureRefused(Exception):
    """Raised by `wait` while the current CUDA stream captures a graph: a
    graph cannot wait on the host, so its capture has to be given up."""


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False in a
    process that has not initialized CUDA, without asking the driver)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def wait(fn, *args, **kw):
    """`fn(*args, **kw)`, a call that waits for the device's queued work
    on a card, counted as one host sync; raises `CaptureRefused` instead
    while the current stream captures."""
    if capturing():
        raise CaptureRefused(f"{getattr(fn, '__name__', fn)} waits on the device")
    count("host_syncs")
    return fn(*args, **kw)


def solve_in(start: float, end: float):
    """The newest solve in `SOLVES` that began in [start, end]
    (`time.perf_counter` seconds), or None."""
    for st in reversed(SOLVES):
        if start <= st.start <= end:
            return st
    return None


def _open(name):
    span = torch.profiler.record_function(name)
    span.__enter__()
    return span


class _Off:
    """`laps` with no profiler recording: every call does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, name=None):
        pass


_OFF = _Off()


class _Laps:
    def __init__(self, name):
        self.name, self.inner = name, None

    def __enter__(self):
        self.outer = _open(self.name)
        return self

    def __exit__(self, *exc):
        self()
        self.outer.__exit__(*exc)
        return False

    def __call__(self, name=None):
        if self.inner is not None:
            self.inner.__exit__(None, None, None)
        self.inner = None if name is None else _open(name)


def laps(name: str):
    """A span `name` whose body is cut into consecutive inner spans (a
    context manager): `lap(inner)` ends the running inner span and opens
    `inner`, `lap()` only ends it.  A no-op unless a profiler records."""
    return _Laps(name) if profiling() else _OFF


class Phases:
    """The phase clock of one solve: `lap(phase, old)` ends the running
    phase, adding its wall to `stats.<phase>_s` and to the older field
    `stats.<old>` where one is named, and starts `phase` (`PHASES`), under
    its span while a profiler records.  A solve's laps tile it from
    `Phases(stats)` to `stop()` (its first is "pop", the set-up), so the
    five phases add up to `total_s`; while a profiler records, less the
    cost of entering and leaving their spans, which no phase holds.
    `stop()` fills `total_s`, `end_ns` and each field of `STATS` (the
    solve's difference of its count) and keeps a copy of the stats in
    `SOLVES`."""

    def __init__(self, stats):
        self.stats = stats
        self.on = False
        self.span = None
        self.fields = ()
        self.counts = {f: counted(name) for f, name in STATS.items()}
        stats.start_ns = time.time_ns()
        stats.start = self.t = time.perf_counter()

    def lap(self, phase, old=None):
        self._end()
        self.fields = (phase + "_s",) if old is None else (phase + "_s", old)
        if phase == "pop":  # a superstep begins with its pop
            self.on = profiling()
        if self.on and PHASES[phase] is not None:
            self.span = _open(PHASES[phase])
        if self.on:
            # the spans' own entries and exits fall between phases
            self.t = time.perf_counter()

    def _end(self):
        """End the running phase, then its span."""
        t = time.perf_counter()
        for f in self.fields:
            setattr(self.stats, f, getattr(self.stats, f) + (t - self.t))
        self.t, self.fields = t, ()
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def stop(self):
        self._end()
        st = self.stats
        st.total_s = self.t - st.start
        st.end_ns = time.time_ns()
        for f, name in STATS.items():
            setattr(st, f, getattr(st, f) + counted(name) - self.counts[f])
        SOLVES.append(copy.copy(st))
