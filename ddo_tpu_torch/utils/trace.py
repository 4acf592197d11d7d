"""The port's timing and counting of itself: spans on the profiler's
timeline, the phase clock of a solve, two process-wide counters and the
stats of recent solves.

Spans.  A span names a stretch of the host's work, "ddo.<layer>.<phase>".
While a `torch.profiler` session records, it is a `record_function`, so
it lies on kineto's timeline and clock with the operations it launches;
otherwise it costs nothing.  Whether a session records is read once per
compile (`laps`) and once per superstep (`Phases.lap` of "pop"), never
per span: entering a `record_function` costs ~13 us on a CPU even with
no profiler, which a compile's ~1,400 layer spans would add to it.  No
name starts with "ddbench.": a benchmark's own spans start so.

Counters.  `host_syncs()` counts the places where the port waits on the
device: every such call goes through `wait`.  They are synchronizes of a
stream, reads of a CUDA tensor on the host (`.cpu()`, `int()`), sizes
that only the device knows (`torch.nonzero`) and copies from host arrays
to the device, which from pageable memory wait for the stream.  They are
counted on the CPU too, where nothing waits, so a CPU run counts the
waits of a card run.  `layers()` counts the layer-loop iterations of
every compile.  A solve's share of each is the difference across it.

Recent solves.  `SOLVES` keeps the `SolverStats` of the last 1,024
finished solves of the process, newest last (`solve_in` finds one by its
start).  It and the two counters are the only state of this module.
"""

from __future__ import annotations

import collections
import copy
import time

import torch

#: the SolverStats of the most recent finished solves, newest last
SOLVES = collections.deque(maxlen=1024)
_counts = {"syncs": 0, "layers": 0}

#: each phase of a solve: its profiler span (None: the compile, whose
#: `compile_lanes` calls open their own)
PHASES = {"pop": "ddo.search.pop", "snapshot": "ddo.search.snapshot", "compile": None,
          "extract": "ddo.extract", "absorb": "ddo.search.absorb"}


def profiling() -> bool:
    """Whether a `torch.profiler` session records now (one attribute read)."""
    return torch.autograd.profiler._is_profiler_enabled


def host_syncs() -> int:
    """Host syncs of this process so far."""
    return _counts["syncs"]


def layers() -> int:
    """Layer-loop iterations of this process so far."""
    return _counts["layers"]


def wait(fn, *args, **kw):
    """`fn(*args, **kw)`, a call that waits for the device's queued work
    on a card, counted as one host sync."""
    _counts["syncs"] += 1
    return fn(*args, **kw)


def count_layers(n: int):
    """Add one compile's layer-loop iterations."""
    _counts["layers"] += n


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
    `stop()` fills `total_s`, `end_ns`, `layers` and `host_syncs` and
    keeps a copy of the stats in `SOLVES`."""

    def __init__(self, stats):
        self.stats = stats
        self.on = False
        self.span = None
        self.fields = ()
        self.syncs, self.layers = host_syncs(), layers()
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
        st.layers += layers() - self.layers
        st.host_syncs += host_syncs() - self.syncs
        SOLVES.append(copy.copy(st))
