"""ddo_tpu_torch — branch-and-bound with decision diagrams on PyTorch and
CUDA: the port of `ddo_tpu` (JAX, TPU) to an NVIDIA H100.

The same design as ddo_tpu: restricted and relaxed MDDs compiled over
whole layers as dense masked tensors, K subproblems per superstep, and a
best-first branch-and-bound over their exact cutsets.  All twelve of
ddo_tpu's models are ported (`models/`: knapsack, misp, max2sat, mcp,
golomb, talentsched, tsptw, sop, srflp, lcs, psp, alp).  The two
functions ddo_tpu wrote as Pallas kernels run as hand-written CUDA
kernels on a GPU (K1, the per-lane multi-key sort in `ops/sort.py`; K2,
the fused backward sweep in `engine/backward.py`) and as plain PyTorch on
the CPU.  `parallel.mesh` splits each superstep's lanes across a mesh of
devices (`MeshSolver`).

The solver alias matrix mirrors solver/mod.rs:29-47 for the solvers that
exist.
"""

from ddo_tpu_torch.core.problem import (
    Dominance,
    ModelBundle,
    Problem,
    Relaxation,
    StateRanking,
)
from ddo_tpu_torch.core.types import (
    Completion,
    CompilationType,
    CutsetType,
    Reason,
    SubProblem,
    Threshold,
    root_subproblem,
)
from ddo_tpu_torch.core.heuristics import (
    Cutoff,
    DivBy,
    FixedWidth,
    NbUnassignedWidth,
    NoCutoff,
    TimeBudget,
    Times,
    WidthHeuristic,
)
from ddo_tpu_torch.engine.mdd import BufferOverflow, CompiledDD, DDCompiler
from ddo_tpu_torch.search.cache import Cache, EmptyCache, SimpleCache
from ddo_tpu_torch.search.dominance import (
    DominanceChecker,
    EmptyDominanceChecker,
    SimpleDominanceChecker,
)
from ddo_tpu_torch.search.fringe import (
    Fringe,
    MaxUB,
    NoDupFringe,
    SimpleFringe,
    SubProblemRanking,
)
from ddo_tpu_torch.search.solver import (
    NativeSolver,
    ParallelSolver,
    SequentialSolver,
    SolverStats,
)
from ddo_tpu_torch.search.device_loop import DeviceLoopSolver
from ddo_tpu_torch import parallel
from ddo_tpu_torch.parallel.mesh import MeshCompiler, MeshSolver, make_mesh
from ddo_tpu_torch.api import Solution, maximize
from ddo_tpu_torch.models.sop import SopWidth
from ddo_tpu_torch.models.srflp import SrflpWidth
from ddo_tpu_torch.models.tsptw import TsptwWidth

from ddo_tpu_torch.utils.num import INF, NEG_INF

LAST_EXACT_LAYER = CutsetType.LAST_EXACT_LAYER
FRONTIER = CutsetType.FRONTIER


def _solver(batch, cache_cls, cutset):
    def make(bundle, **kw):
        kw.setdefault("cache", cache_cls())
        kw.setdefault("cutset_type", cutset)
        kw.setdefault("batch", batch)
        return SequentialSolver(bundle, **kw)

    return make


# Solver alias matrix (solver/mod.rs:29-47): {Seq,Par} x {Caching,NoCaching}
# x {Lel, Fc, Pooled}.  The Pooled variants use the frontier-cutset engine
# (the reference pooled MDD is frontier-only, pooled.rs:537); its long arcs
# are engaged whenever the model overrides `Problem.is_impacted_by`
# (engine/mdd.py).
SeqNoCachingSolverLel = _solver(1, EmptyCache, LAST_EXACT_LAYER)
SeqNoCachingSolverFc = _solver(1, EmptyCache, FRONTIER)
SeqCachingSolverLel = _solver(1, SimpleCache, LAST_EXACT_LAYER)
SeqCachingSolverFc = _solver(1, SimpleCache, FRONTIER)
ParNoCachingSolverLel = _solver(16, EmptyCache, LAST_EXACT_LAYER)
ParNoCachingSolverFc = _solver(16, EmptyCache, FRONTIER)
ParCachingSolverLel = _solver(16, SimpleCache, LAST_EXACT_LAYER)
ParCachingSolverFc = _solver(16, SimpleCache, FRONTIER)
SeqCachingSolverPooled = SeqCachingSolverFc
SeqNoCachingSolverPooled = SeqNoCachingSolverFc
ParCachingSolverPooled = ParCachingSolverFc
ParNoCachingSolverPooled = ParNoCachingSolverFc

DefaultSolver = ParNoCachingSolverLel  # solver/mod.rs:29
DefaultCachingSolver = ParCachingSolverFc  # solver/mod.rs:30

__all__ = [n for n in dir() if not n.startswith("_")]
