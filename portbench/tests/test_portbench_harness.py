"""The harness finds cells, configurations and metric readers by name,
BENCHMARK.json keeps to the benchmark's contract, and a run's last line
has its schema."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_cell_found_by_name(cell):
    """The cell's workload file, its configuration, its driver and every
    metric it reports, each found by name; every cell reports setup_s,
    another end-to-end metric and a per-layer metric."""
    wl, cfg = harness.cell_files(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] == cfg["name"]
    assert wl["traffic"] == entry["traffic"]
    assert os.path.isfile(os.path.join(harness.BENCH, "drivers",
                                       f"{wl['driver']}.py"))
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
    layer = [m["name"] for m in harness.cell_metrics(BENCH, cell, True)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for name in e2e + layer:
        mod = harness.load_module(
            os.path.join(harness.BENCH, "metrics", f"{name}.py"), name)
        assert callable(mod.read)
        assert mod.read({}) is None or name == "setup_s"
    for key in wl["limits"]:
        assert NAME.match(key)


def test_config_files_state_reduced_keys():
    for c in BENCH["configs"]:
        data = harness.load_json(harness.ROOT, c["file"])
        assert data["reduced"] == c["reduced"]
        assert data["precision"]["tf32"] is False


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(trace):
    line = cells.run("train.b8", trace=trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    want = {m["name"] for m in harness.cell_metrics(BENCH, "train.b8", trace)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert {"setup_s", "train_examples_per_s"} <= set(line["metrics"])
    else:
        assert "breakdown" in keys and "busy_s" in line["device"]
    for value, limit in line["checks"].values():
        assert isinstance(value, float) and isinstance(limit, float)


def test_run_refuses_without_a_card(tmp_path):
    """With no usable card the command exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"),
         "--workload", "train.b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_union_of_device_spans():
    busy, gaps = harness._union([(0, 10), (5, 12), (20, 25), (25, 30)])
    assert busy == 22 and gaps == [(8, 12)]
