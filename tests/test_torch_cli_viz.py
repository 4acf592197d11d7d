"""CLI and Graphviz parity (ddo_tpu_torch/cli.py, ddo_tpu_torch/engine/viz.py):
both packages' `cli.main([..., "--cpu"])` on one generated instance file
print the same lines, Duration and Stats aside, with and without
`--device-loop`; `as_graphviz` of the same relaxed root DD is the same
text in both packages; `--dot` writes it.  Instances are written to
`tmp_path`, none is read from the resources tree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import ddo_tpu
import ddo_tpu_torch as tt
from ddo_tpu.cli import main as jax_main
from ddo_tpu.engine.viz import VizConfig as JVizConfig, as_graphviz as jax_graphviz
from ddo_tpu.models import knapsack as jk
from ddo_tpu_torch import cli
from ddo_tpu_torch.engine.viz import VizConfig, as_graphviz
from ddo_tpu_torch.models import knapsack as tk, misp as tm
from ddo_tpu_torch.utils import resources


@pytest.fixture
def no_jax_disk_cache(monkeypatch):
    """ddo_tpu's CLI turns on JAX's on-disk compilation cache, which the
    test suite keeps off (tests/conftest.py); drop that one setting."""
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if name == "jax_compilation_cache_dir" else update(name, value))


def write_knapsack(path, seed=8, n=20):
    rng = np.random.default_rng(seed)
    w = rng.integers(10, 40, n)
    p = w + rng.integers(0, 6, n)
    lines = [f"{n} {int(w.sum() // 2)}"] + [f"{a} {b}" for a, b in zip(p, w)]
    path.write_text("\n".join(lines) + "\n")
    return tk.read_instance(str(path))


def run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def comparable(lines):
    return [l for l in lines if not l.startswith(("Duration:", "Stats:"))]


@pytest.mark.parametrize("loop", [[], ["--device-loop", "--slab-cap", "64",
                                       "--chunk-steps", "4"]])
def test_cli_lines_match_ddo_tpu(tmp_path, capsys, no_jax_disk_cache, loop):
    pb = write_knapsack(tmp_path / "kp.txt")
    argv = ["knapsack", str(tmp_path / "kp.txt"), "--cpu", "-w", "3"] + loop
    want = run(jax_main, argv, capsys)
    got = run(cli.main, argv, capsys)
    assert comparable(got) == comparable(want)
    assert f"Objective:  {tk.dp_optimum(pb.capacity, pb.profit, pb.weight)}" in got
    assert "Aborted:    False" in got
    assert len(got) == len(want) == 10


def test_cli_misp_and_golomb(tmp_path, capsys):
    pb, edges = tm.generate_gnp(12, 0.3, seed=1)
    path = tmp_path / "g.clq"
    path.write_text(f"p edge 12 {len(edges)}\n" + "".join(f"e {a + 1} {b + 1}\n"
                                                          for a, b in edges))
    out = run(cli.main, ["misp", str(path), "--cpu", "--cutset", "frontier"], capsys)
    best = max(bin(s).count("1") for s in range(1 << 12)
               if not any((s >> a & 1) and (s >> b & 1) for a, b in edges))
    assert f"Objective:  {best}" in out and "Aborted:    False" in out
    out = run(cli.main, ["golomb", "4", "--cpu", "--device-loop", "--slab-cap", "64"], capsys)
    assert "Objective:  6" in out and "Gap:        0.000" in out


def test_cli_dot_and_default_device(tmp_path, capsys):
    write_knapsack(tmp_path / "kp.txt", seed=3, n=6)
    dot = tmp_path / "root.dot"
    out = run(cli.main, ["knapsack", str(tmp_path / "kp.txt"), "--cpu", "--dot", str(dot)],
              capsys)
    assert f"Dot:        {dot}" in out
    text = dot.read_text()
    assert text.startswith("digraph {") and "terminal" in text and "->" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["knapsack", str(tmp_path / "kp.txt")])
    with pytest.raises(SystemExit):
        cli.build("nosuchmodel", "x")


@pytest.mark.parametrize("group_merged", [False, True])
def test_graphviz_text_matches_ddo_tpu(group_merged):
    rng = np.random.default_rng(5)
    jp = jk.Knapsack(40, rng.integers(1, 30, 8), rng.integers(1, 15, 8))
    pb = tk.Knapsack.from_numpy(jp.capacity, jp.profit, jp.weight)
    jdd = ddo_tpu.SequentialSolver(
        ddo_tpu.ModelBundle(jp, jk.KPRelax(jp), jk.KPRanking()),
        width_heu=ddo_tpu.FixedWidth(3)).compiler.compile(
        ddo_tpu.CompilationType.RELAXED, ddo_tpu.root_subproblem(jp), ddo_tpu.NEG_INF, 3)
    tdd = tt.SequentialSolver(
        tt.ModelBundle(pb, tk.KPRelax(pb), tk.KPRanking()), width_heu=tt.FixedWidth(3),
        device="cpu").compiler.compile(
        tt.CompilationType.RELAXED, tt.root_subproblem(pb), tt.NEG_INF, 3)
    want = jax_graphviz(jdd, JVizConfig(group_merged=group_merged))
    got = as_graphviz(tdd, VizConfig(group_merged=group_merged))
    assert got == want
    assert "val:" in got and "rub:" in got and "theta:" in got
    assert ("cluster_" in got) == group_merged


def test_resources_root_reads_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("DDO_RESOURCES", str(tmp_path))
    assert resources.resources_root() == str(tmp_path)
    monkeypatch.delenv("DDO_RESOURCES")
    assert resources.resources_root() == resources.DEFAULT_ROOT
