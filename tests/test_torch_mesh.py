"""Mesh parity (ddo_tpu_torch/parallel/mesh.py) on the CPU, with meshes of
N "cpu" entries (the lane split runs where there is one device):

  * `MeshCompiler` on 1, 3 and 8 entries, with 1, 3, 8 and 13 lanes rooted
    at different depths, against `DDCompiler` on the same lanes: every
    plane of every real lane bit for bit, for RESTRICTED, RELAXED and
    `compile_fused`, with cache and dominance filter tables; views for
    the real lanes only; `global_best` and `total_expanded` the active
    lanes' max and sum;
  * the same lanes against ddo_tpu's `MeshCompiler` on conftest's
    8-device virtual CPU mesh, each lane from its root depth down
    (ROADMAP C.2.4);
  * `MeshSolver` against ddo_tpu's `MeshSolver` and against the port's
    `SequentialSolver(batch=mesh size)` on tests/test_mesh.py's two
    seed-42 knapsacks and a MISP G(20, 0.3): optimum, bounds, exactness,
    explored and expanded counts;
  * the mesh's chunked cutoff and `TimeBudget(0.0)`, and `make_mesh()` /
    `MeshSolver()` without a card.

Instances are generated from seeds; none is read from the resources tree.
Tolerance: exact, every value is an integer or a bool."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.models import knapsack as jk
from ddo_tpu.parallel.mesh import MeshCompiler as JMeshCompiler, MeshSolver as JMeshSolver
from ddo_tpu.parallel.mesh import make_mesh as j_make_mesh
from ddo_tpu_torch.engine.mdd import CutoffInterrupt, DDCompiler, tmap
from ddo_tpu_torch.models import knapsack as tk
from ddo_tpu_torch.parallel.mesh import MeshCompiler, MeshSolver, make_mesh
from ddo_tpu_torch.search.cache import tables_to_device
from ddo_tpu_torch.utils.num import NEG_INF

from test_torch_models import misp_pair
from test_torch_tsptw import layer_planes_equal, to_jax_sub

CT = tt.CompilationType
W = 8
WIDTHS = [2, 3, 1, 4, 2, 5]


def seed42_knapsacks():
    """tests/test_mesh.py:38-46's two random knapsacks (n=14), as
    (ddo_tpu bundle, port bundle) pairs."""
    rng = np.random.default_rng(42)
    pairs = []
    for _ in range(2):
        profit = rng.integers(1, 50, 14)
        weight = rng.integers(1, 30, 14)
        jp = jk.Knapsack(int(weight.sum() // 2), profit, weight)
        pb = tk.Knapsack.from_numpy(jp.capacity, jp.profit, jp.weight)
        pairs.append((ddo_tpu.ModelBundle(jp, jk.KPRelax(jp), jk.KPRanking()),
                      tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())))
    return pairs


def lane_pool(tb):
    """The root and the cutset nodes of relaxed compiles of it at width 2
    (both cutsets), deepest first: lanes rooted at different depths."""
    root = tt.root_subproblem(tb.problem)
    pool = {}
    for cutset in (tt.FRONTIER, tt.LAST_EXACT_LAYER):
        dd = DDCompiler(tb, W, cutset, device="cpu").compile(CT.RELAXED, root, NEG_INF, 2)
        for s in dd.drain_cutset():
            pool.setdefault((s.depth, s.key), s)
    pool = sorted(pool.values(), key=lambda s: -s.depth) + [root]
    assert len({s.depth for s in pool}) >= 4
    return pool


def lanes_of(pool, count):
    subs = [pool[i % len(pool)] for i in range(count)]
    return subs, [WIDTHS[i % len(WIDTHS)] for i in range(count)]


def port_tables(tb, dom):
    """Cache and dominance filter tables filled from a relaxed compile of
    the root at width 3."""
    pb = tb.problem
    dd = DDCompiler(tb, W, tt.FRONTIER, dominance=dom, device="cpu").compile(
        CT.RELAXED, tt.root_subproblem(pb), NEG_INF, 3)
    cache = tt.SimpleCache()
    cache.initialize(pb)
    cache.update_batch(*dd.cache_batch())
    store = tt.SimpleDominanceChecker(dom, pb.nb_variables)
    store.insert_batch(*dd.exact_nodes_batch())
    return cache.snapshot("cpu"), store.snapshot("cpu")


def real(get, k):
    """A plane lookup restricted to the first k (real) lanes."""
    return lambda name: tmap(lambda a: a[:k], get(name))


def assert_same_batch(mesh_batch, ref_batch, k):
    assert len(mesh_batch) == len(ref_batch) == k
    mget, rget = mesh_batch._planes.get, ref_batch._planes.get
    for name in ref_batch.dev:
        m, r = real(mget, k)(name), rget(name)
        for leaf, rv in (r.items() if isinstance(r, dict) else [(name, r)]):
            mv = m[leaf] if isinstance(m, dict) else m
            np.testing.assert_array_equal(mv, rv, err_msg=name)
    act = mesh_batch.actives.numpy()
    np.testing.assert_array_equal(act[:k], ref_batch.actives.numpy())
    assert not act[k:].any()  # the pads
    lanes = ref_batch.actives.numpy()
    best = rget("bx_value")[lanes & rget("bx_feasible")]
    assert mesh_batch.global_best == ref_batch.global_best == \
        (int(best.max()) if len(best) else NEG_INF)
    assert mesh_batch.total_expanded == ref_batch.total_expanded == \
        int(rget("expanded")[lanes].sum())


@pytest.mark.parametrize("lanes", [1, 3, 8, 13])
@pytest.mark.parametrize("size", [1, 3, 8])
def test_mesh_compiler_planes_equal_ddcompiler(size, lanes):
    _, tb = seed42_knapsacks()[0]
    dom = tk.KPDominance()
    subs, widths = lanes_of(lane_pool(tb), lanes)
    tabs = port_tables(tb, dom)
    mc = MeshCompiler(tb, W, tt.FRONTIER, make_mesh(["cpu"] * size), dominance=dom)
    dc = DDCompiler(tb, W, tt.FRONTIER, dominance=dom, device="cpu")
    assert mc.lanes == size and mc.device == torch.device("cpu")
    for comp in (CT.RESTRICTED, CT.RELAXED):
        got = mc.compile_batch(comp, subs, NEG_INF, widths, *tabs)
        want = dc.compile_batch(comp, subs, NEG_INF, widths, *tabs)
        assert got.dev["value"].shape[0] == size * -(-lanes // size)
        assert_same_batch(got, want, lanes)
    for got, want in zip(mc.compile_fused(subs, NEG_INF, widths, *tabs),
                         dc.compile_fused(subs, NEG_INF, widths, *tabs)):
        assert_same_batch(got, want, lanes)


def jax_tables(jb, dom):
    """ddo_tpu's counterpart of `port_tables`: its own stores, filled from
    its own compile, snapshotted as numpy tables."""
    pb = jb.problem
    dd = ddo_tpu.DDCompiler(jb, W, ddo_tpu.FRONTIER, dominance=dom).compile(
        ddo_tpu.CompilationType.RELAXED, ddo_tpu.root_subproblem(pb), NEG_INF, 3)
    cache = ddo_tpu.SimpleCache()
    cache.initialize(pb)
    cache.update_batch(*dd.cache_batch())
    store = ddo_tpu.SimpleDominanceChecker(dom, pb.nb_variables)
    store.insert_batch(*dd.exact_nodes_batch())
    return cache.snapshot(), store.snapshot()


@pytest.mark.parametrize("lanes", [1, 3, 8, 13])
def test_mesh_compiler_matches_ddo_tpu(lanes):
    """The port's mesh of 3 entries against ddo_tpu's 8-device mesh, one
    fused superstep (its restricted and its relaxed pass): every plane of
    every real lane from its root depth down, and the reductions, with the
    same filter tables on both sides."""
    jb, tb = seed42_knapsacks()[0]
    jdom, tdom = jk.KPDominance(), tk.KPDominance()
    subs, widths = lanes_of(lane_pool(tb), lanes)
    jtabs = jax_tables(jb, jdom)
    ttabs = tuple(tables_to_device(t, "cpu") for t in jtabs)
    jc = JMeshCompiler(jb, W, ddo_tpu.FRONTIER, j_make_mesh(), dominance=jdom)
    assert jc.lanes == len(jax.devices()) == 8
    tc = MeshCompiler(tb, W, tt.FRONTIER, make_mesh(["cpu"] * 3), dominance=tdom)
    for jbatch, tbatch in zip(
            jc.compile_fused([to_jax_sub(s, ()) for s in subs], NEG_INF, widths, *jtabs),
            tc.compile_fused(subs, NEG_INF, widths, *ttabs)):
        assert len(jbatch) == len(tbatch) == lanes
        layer_planes_equal(real(jbatch._planes.get, lanes), real(tbatch._planes.get, lanes),
                           [s.depth for s in subs], ("dkey", "dcoord"))
        assert jbatch.global_best == tbatch.global_best
        assert jbatch.total_expanded == tbatch.total_expanded


def solver_pair(case):
    if case < 2:
        return ("knapsack",) + seed42_knapsacks()[case] + (3,)
    jb, tb, _ = misp_pair(20, 0, p=0.3)
    return "misp", jb, tb, 4


def outcome(s):
    return (s.best_value(), s.best_upper_bound(), s.explored_count, s.expanded_nodes,
            s.stats.supersteps)


@functools.lru_cache(maxsize=None)
def jax_mesh_solve(case):
    """ddo_tpu's `MeshSolver` on its 8-device mesh (batch 8): `outcome`
    and the best solution."""
    _, jb, _, width = solver_pair(case)
    js = JMeshSolver(jb, mesh=j_make_mesh(), width_heu=ddo_tpu.FixedWidth(width),
                     cache=ddo_tpu.SimpleCache(), cutset_type=ddo_tpu.FRONTIER)
    assert js.maximize().is_exact and js.batch == 8 and js._compact is False
    return outcome(js), js.best_solution()


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("size", [3, 8])
def test_mesh_solver_matches_ddo_tpu(case, size):
    """The same proof as ddo_tpu's `MeshSolver` on its 8-device mesh and as
    the port's `SequentialSolver` at batch 8 (the plane route, as
    ddo_tpu's on the CPU): optimum, best upper bound, exactness, solution,
    explored and expanded counts and supersteps."""
    name, _, tb, width = solver_pair(case)
    want, want_sol = jax_mesh_solve(case)
    kw = dict(batch=8, width_heu=tt.FixedWidth(width), cache=tt.SimpleCache(),
              cutset_type=tt.FRONTIER)
    ms = MeshSolver(tb, mesh=make_mesh(["cpu"] * size), **kw)
    ss = tt.SequentialSolver(tb, device="cpu", **kw)
    assert isinstance(ms.compiler, MeshCompiler) and ms.compiler.lanes == size
    assert ms.compiler.width == ss.compiler.width and ms._compact is ss._compact is False
    for s in (ms, ss):
        assert s.maximize().is_exact
        assert outcome(s) == want, name
        for a, b in zip(want_sol, s.best_solution()):
            np.testing.assert_array_equal(a, b)


def test_mesh_solver_default_batch_is_mesh_size():
    _, tb = seed42_knapsacks()[1]
    s = MeshSolver(tb, mesh=make_mesh(["cpu"] * 3), width_heu=tt.FixedWidth(3))
    assert s.batch == 3 and s.device == s.compiler.device == torch.device("cpu")
    ref = tt.SequentialSolver(tb, batch=3, width_heu=tt.FixedWidth(3), device="cpu")
    assert s.maximize().is_exact and ref.maximize().is_exact
    assert (s.best_value(), s.explored_count, s.expanded_nodes) == \
        (ref.best_value(), ref.explored_count, ref.expanded_nodes)


class FiresAfterOne:
    def __init__(self):
        self.calls = 0

    def must_stop(self):
        self.calls += 1
        return self.calls > 1


def test_mesh_chunked_compile_interrupts_on_cutoff():
    """tests/test_mesh.py:59-84 on a generated n=20 knapsack: the first
    shard's second poll fires (5 chunks of 4 layers)."""
    pb = tk.generate_uncorrelated(20, 100, 1, 2, seed=3)
    bundle = tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking())
    compiler = MeshCompiler(bundle, 8, tt.FRONTIER, make_mesh(["cpu"] * 2))
    root = tt.root_subproblem(pb)
    cutoff = FiresAfterOne()
    with pytest.raises(CutoffInterrupt):
        compiler.compile_batch(CT.RELAXED, [root] * 3, -(10**9), [2] * 3,
                               cutoff=cutoff, chunk_layers=4)
    assert cutoff.calls == 2


def test_mesh_solver_honors_time_budget():
    """tests/test_mesh.py:87-98: `TimeBudget(0.0)` aborts cleanly, gap 1."""
    pb = tk.generate_uncorrelated(20, 100, 1, 2, seed=3)
    s = MeshSolver(tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking()),
                   mesh=make_mesh(["cpu"] * 2), width_heu=tt.FixedWidth(2),
                   cutoff=tt.TimeBudget(0.0))
    c = s.maximize()
    assert not c.is_exact and s.gap() == 1.0


def test_make_mesh_and_mesh_solver_need_a_card(monkeypatch):
    """Without a card the default mesh raises (no CPU fallback); an explicit
    list of devices, repeats included, is taken in order."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    _, tb = seed42_knapsacks()[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshSolver(tb)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshCompiler(tb, W, tt.FRONTIER, make_mesh(["cuda:0", "cuda:0"]))
    m = make_mesh(["cpu", "cpu"], axis="x")
    assert m.size == 2 and m.axis == "x" and m.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh([])
