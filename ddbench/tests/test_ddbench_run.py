"""A run's whole path on the CPU at a size a test can hold (the harness's
look for a card skipped), its refusals, the control, and the faults that
`correct` has to catch; on a card, a short run of each cell."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ddo_tpu_torch as tt
from ddbench import cell as cells, control, judge

SMALL = {"kp-uncorr-n100": {"n": 24, "width": 8, "batch": 4},
         "tsptw-n20w40": {"n": 7, "window": 100.0, "width": 8, "batch": 4}}
CELLS = sorted(SMALL)
SEED = 2**31 + 77


def run(name, trace=False, seconds=0.5):
    cell = cells.Cell(name, overrides=SMALL[name])
    return cells.run_cell(cell, SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_run_on_the_cpu_is_correct(name):
    result, lines = run(name)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"solve_p95_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert lines[-3:] == [f"{n} 0 limit 0" for n in judge.LIMITS]
    assert cells.forbidden_modules() == []


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_counters_not_device_numbers(name):
    result, _ = run(name, trace=True, seconds=1.0)
    assert result["correct"]
    # a CPU run writes no number under a device metric's name
    assert set(result["metrics"]) == {"search_host_pct", "supersteps_per_solve",
                                      "compile_expansions_per_s"}
    assert result["metrics"]["supersteps_per_solve"]["value"] >= 1
    assert "breakdown" in result and result["device"]["window_s"] > 0


def test_tsptw_proof_at_width_8_matches_the_reference():
    """Instance 7 of SEED's stream at the CPU runs' size (n=7, W=8): the
    port proves it infeasible, and so does ddo_tpu, where brute force and
    the reference find the tour of -1549677 (W=16 finds it too).  A fault
    of the program, which this test shows until the program is mended;
    the CPU runs above fail where their window reaches this instance."""
    cell = cells.Cell("tsptw-n20w40", overrides=SMALL["tsptw-n20w40"])
    inst = cell.instance(SEED, cells.MEASURED, 7)
    assert cell.ref.optimum(inst) == -1549677
    r = cells.solve(cell, inst, 60.0, "cpu")
    assert r["exact"] and r["objective"] == -1549677


def _stuck(self, batch):
    """A superstep that returns the search's state unchanged."""


def _half_of_each_layer(port_model):
    def model(inst):
        problem, relax, ranking, dominance = port_model(inst)
        step = problem.step

        def half(data, states, var, depth):
            nstate, cost, dval, valid = step(data, states, var, depth)
            keep = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
            return nstate, cost, dval, valid & keep[:, None]

        problem.step = half
        return problem, relax, ranking, dominance
    return model


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    """The faults a cell of one chip can have; no exchange between chips
    exists to leave out."""
    cell = cells.Cell(name, overrides=SMALL[name])
    if fault == "state_unchanged":
        monkeypatch.setattr(tt.SequentialSolver, "_process_batch", _stuck)
    elif fault == "half_left_out":
        monkeypatch.setattr(cell.family, "port_model", _half_of_each_layer(cell.family.port_model))
    else:
        update = tt.SequentialSolver._maybe_update_best

        def altered(self, dd):
            before = self.best_lb
            update(self, dd)
            if self.best_lb != before:
                self.best_lb += 1

        monkeypatch.setattr(tt.SequentialSolver, "_maybe_update_best", altered)
    result, lines = cells.run_cell(cell, SEED, 1.0, False, device="cpu")
    assert not result["correct"]
    assert any(not line.endswith(" 0 limit 0") for line in lines[-3:])


@pytest.mark.parametrize("name, count", [("kp-uncorr-n100", 40), ("tsptw-n20w40", 120)])
def test_control_is_not_correct(name, count, capsys):
    assert control.main(["--workload", name, "--seeds", "1,2,3", "--count", str(count)]) == 0
    readings = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(readings) == 3 and not any(r["correct"] for r in readings)
    assert all(r["counts"]["wrong_value"] > judge.LIMITS["wrong_value"] for r in readings)


def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "ddbench/run.py", "--workload", "kp-uncorr-n100",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = _run_py(cells.ROOT, env)
    assert p.returncode != 0 and p.stdout == "" and "no CUDA device" in p.stderr


def test_run_py_refuses_without_the_port(tmp_path):
    import shutil

    shutil.copytree(cells.HERE, tmp_path / "ddbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = cells.Cell(name)
    result, _ = cells.run_cell(cell, SEED, 2.0, True, device="cuda")
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0 and "k1_roofline" in result["metrics"]
