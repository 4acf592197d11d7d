"""BENCHMARK.json against the contract's shapes, the files the harness
finds by name, and the imports of every file under ddbench/."""

import ast
import json
import os
import re

import pytest

from ddbench import cell as cells

BENCH = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
PY_FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(cells.HERE)
                  for f in fs if f.endswith(".py"))
#: the files of the yardstick, which import nothing of the port
REFERENCE = ("judge.py", "stats.py", "roofline.py", "control.py")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "ddbench/run.py"]
    assert BENCH["paths"] == ["ddbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entries_have_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cell_names)) <= cell_names


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_files(name):
    cell = cells.Cell(name)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    # each per-layer metric moves an end-to-end metric the cell reports
    assert {m["moves"] for m, _ in cell.per_layer} <= {m["name"] for m in cell.end_to_end}
    for fn in ("generate", "port_model"):
        assert callable(getattr(cell.family, fn))
    for fn in ("optimum", "replay", "control"):
        assert callable(getattr(cell.ref, fn))


def test_config_files_are_the_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("ddbench/")
        conf = json.load(open(os.path.join(cells.ROOT, c["file"])))
        assert conf["name"] == c["name"] and sorted(conf["reduced"]) == sorted(c["reduced"])


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: os.path.relpath(p, cells.HERE))
def test_no_file_imports_jax_or_the_jax_package(path):
    # whole top-level names: ddo_tpu_torch is the port, ddo_tpu is not
    assert not set(imported(path)) & {"jax", "jaxlib", "flax", "ddo_tpu"}


@pytest.mark.parametrize("path", [p for p in PY_FILES if os.path.basename(p) in REFERENCE
                                  or p.endswith("_ref.py")],
                         ids=lambda p: os.path.relpath(p, cells.HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "ddo_tpu_torch" not in set(imported(path))
