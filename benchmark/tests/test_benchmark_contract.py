"""BENCHMARK.json against the files the harness finds by name."""

import json
import os
import re

import pytest

from benchmark import catalog

ROOT = os.path.dirname(catalog.HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    B = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in B["end_to_end"]}


def test_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(B)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E[
        "setup_s"]
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_its_files(w):
    cell = catalog.cell(w["name"])
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        w["config"], w["traffic"], w["chips"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert len(w["why"]) <= 200
    reported = cell["mix"]["end_to_end"]
    for name in reported:
        assert w["name"] in E2E[name]["workloads"]
    for m in B["end_to_end"]:
        if "workloads" in m and w["name"] in m["workloads"]:
            assert m["name"] in reported
    layer = [m for m in B["per_layer"] if w["name"] in m["workloads"]]
    assert layer, "every cell reports a per-layer metric"


def test_cells_are_the_files():
    assert sorted(w["name"] for w in B["workloads"]) == catalog.cells()


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_every_configuration_is_its_file(c):
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    arch = catalog.load("configs", c["name"])
    assert arch["reduced"] == c["reduced"]
    assert all(k in arch for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in B["workloads"])
    assert arch["source"] == c["source"]


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_is_its_reader(m):
    reader = catalog.metric_readers()[m["name"]]
    assert (reader.MOVES, reader.UNIT, reader.LAYER) == (
        m["moves"], m["unit"], m["layer"])
    for cell in m["workloads"]:
        assert m["moves"] in catalog.cell(cell)["mix"]["end_to_end"]
    assert set(catalog.metric_readers()) == {x["name"]
                                             for x in B["per_layer"]}


def test_the_harness_units_are_the_benchmarks():
    from benchmark import harness
    for name, m in E2E.items():
        assert harness.UNITS[name] == m["unit"]


def test_the_command_runs_the_harness():
    assert B["command"] == ["python3", "-m", "benchmark.run"]
    assert os.path.exists(os.path.join(catalog.HERE, "run.py"))
