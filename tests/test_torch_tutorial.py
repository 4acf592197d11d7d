"""The port's custom-model tutorial (examples/tutorial_custom_problem_torch.py)
against ddo_tpu's (examples/tutorial_custom_problem.py), both loaded by
path, on the tutorial's instance (`default_rng(7)`, 14 jobs):

  * `main(device="cpu")` proves brute force's optimum, on the JAX
    tutorial's search trajectory (explored and expanded counts);
  * every hook of the port's `IntervalScheduling`, `IntervalRelax` and
    `IntervalRanking` against the JAX tutorial's under `jax.vmap`;
  * every plane of restricted and relaxed compiles (one deep lane, and
    four lanes rooted at different depths, each from its root depth down);
  * the Graphviz text of the tutorial's relaxed root DD, as
    tests/test_torch_cli_viz.py compares it.

Tolerance: exact, every value is an integer or a bool."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.engine.viz import VizConfig as JVizConfig, as_graphviz as jax_graphviz
from ddo_tpu_torch.engine.viz import VizConfig, as_graphviz

from test_torch_tsptw import check_compiles, check_hooks, rollout

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def load(name, filename):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TORCH_TUTORIAL = load("tutorial_custom_problem_torch", "tutorial_custom_problem_torch.py")
JAX_TUTORIAL = load("tutorial_custom_problem", "tutorial_custom_problem.py")


def bundles():
    """The tutorial's instance in both packages: (ddo_tpu bundle, port bundle)."""
    start, end, profit = TORCH_TUTORIAL.instance()
    j, t = JAX_TUTORIAL, TORCH_TUTORIAL
    jp = j.IntervalScheduling(start, end, profit)
    pb = t.IntervalScheduling(start, end, profit)
    return (ddo_tpu.ModelBundle(jp, j.IntervalRelax(jp), j.IntervalRanking()),
            tt.ModelBundle(pb, t.IntervalRelax(pb), t.IntervalRanking()))


def test_main_on_the_cpu_proves_brute_force_optimum(capsys):
    start, end, profit = TORCH_TUTORIAL.instance()
    expected = TORCH_TUTORIAL.brute_force(start.tolist(), end.tolist(), profit.tolist())
    solver = TORCH_TUTORIAL.main(device="cpu")
    assert solver.device == torch.device("cpu")
    assert solver.best_value() == expected and solver.gap() == 0.0
    out = capsys.readouterr().out
    assert f"brute force agrees: {expected}" in out and "proved optimal: True" in out


def test_search_matches_the_jax_tutorial(capsys):
    """`main`'s solver and the JAX tutorial's (FixedWidth(4), SimpleCache,
    the frontier cutset, batch 4) take one trajectory: optimum, bounds,
    explored and expanded counts, supersteps and the jobs taken."""
    jb, _ = bundles()
    js = ddo_tpu.SequentialSolver(jb, width_heu=ddo_tpu.FixedWidth(4),
                                  cache=ddo_tpu.SimpleCache(),
                                  cutset_type=ddo_tpu.FRONTIER, batch=4)
    assert js.maximize().is_exact and js._compact is False
    ts = TORCH_TUTORIAL.main(device="cpu")
    assert (ts.best_value(), ts.best_upper_bound()) == (js.best_value(), js.best_upper_bound())
    assert (ts.explored_count, ts.expanded_nodes, ts.stats.supersteps) == \
        (js.explored_count, js.expanded_nodes, js.stats.supersteps)
    for a, b in zip(js.best_solution(), ts.best_solution()):
        np.testing.assert_array_equal(a, b)


def test_hooks_match_the_jax_tutorial():
    jb, tb = bundles()
    check_hooks(jb, tb, (), rollout(tb))


def test_planes_match_the_jax_tutorial():
    jb, tb = bundles()
    check_compiles(jb, tb, (), 8, [2, 3, 8, 4])


def test_graphviz_matches_the_jax_tutorial():
    """The tutorial's own export: the relaxed root DD at width 8, 3 nodes
    per layer, values and rough bounds shown."""
    jb, tb = bundles()
    jdd = ddo_tpu.DDCompiler(jb, width=8, cutset_type=ddo_tpu.FRONTIER).compile(
        ddo_tpu.CompilationType.RELAXED, ddo_tpu.root_subproblem(jb.problem),
        best_lb=-(10**9), eff_width=3)
    tdd = tt.DDCompiler(tb, width=8, cutset_type=tt.FRONTIER, device="cpu").compile(
        tt.CompilationType.RELAXED, tt.root_subproblem(tb.problem), best_lb=-(10**9),
        eff_width=3)
    want = jax_graphviz(jdd, JVizConfig(show_value=True, show_rub=True))
    got = as_graphviz(tdd, VizConfig(show_value=True, show_rub=True))
    assert got == want
    assert "val:" in got and "rub:" in got and "terminal" in got


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TORCH_TUTORIAL.main()
